"""The keypoint-labeling tools' core (`labeling.py`), host numpy."""
