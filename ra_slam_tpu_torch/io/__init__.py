"""RGB-D datasets (counterpart of `ra_slam_tpu.io`) and a PNG writer.

Only the synthetic box room is ported so far; the `.sens` and folder
readers need cv2/yaml and wait in the ROADMAP.
"""
