"""Keypoint and skeleton plotting in the COCO and CrowdPose orders (reference:
tools/vis.py).

The port's copy of buctd_tpu/utils/skeletons.py: it lives in the package so
analysis code can import it without reaching into tools/."""

import numpy as np

COCO_SKELETON = [(0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 6),
                 (5, 7), (7, 9), (6, 8), (8, 10), (5, 11), (6, 12),
                 (11, 12), (11, 13), (13, 15), (12, 14), (14, 16)]
CROWDPOSE_SKELETON = [(0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (0, 6), (1, 7),
                      (6, 7), (6, 8), (7, 9), (8, 10), (9, 11), (0, 12),
                      (1, 12), (12, 13), (2, 13), (3, 13)]

COCO_KEYPOINT_ORDER = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle"]
CROWDPOSE_KEYPOINT_ORDER = [
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle", "head", "neck"]


def plot_keypoints(image, keypoints, dataset="coco", color="red"):
    """Draw keypoints + skeleton onto ``image`` (in place), like the reference."""
    import cv2

    if dataset == "coco":
        skeleton = COCO_SKELETON
    elif dataset == "crowdpose":
        skeleton = CROWDPOSE_SKELETON
    else:
        raise ValueError("Dataset not supported. Choose 'coco' or 'crowdpose'")

    keypoints = np.asarray(keypoints)
    for joint in keypoints:
        x, y = joint[:2].astype(int)
        cv2.circle(image, (int(x), int(y)), 3, color, thickness=2)
    for start, end in skeleton:
        x1, y1 = keypoints[start][:2].astype(int)
        x2, y2 = keypoints[end][:2].astype(int)
        cv2.line(image, (int(x1), int(y1)), (int(x2), int(y2)), color, 2)
    return image
