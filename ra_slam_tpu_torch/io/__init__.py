"""RGB-D datasets (counterpart of `ra_slam_tpu.io`): the synthetic box
room, logged folders (`folder.py`), ScanNet `.sens` files (`sens.py`),
and the PNG (`png.py`) and JPEG (`jpeg.py`, nvjpeg on a CUDA device)
codecs they read through, none of which needs cv2, PyYAML or PIL.
"""
