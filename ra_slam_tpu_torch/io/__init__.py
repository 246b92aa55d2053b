"""RGB-D datasets (counterpart of `ra_slam_tpu.io`).

Only the synthetic box room is ported so far; the `.sens` and folder
readers need cv2/yaml and wait in the ROADMAP.
"""
