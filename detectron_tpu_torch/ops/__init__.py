"""Box math, anchors, NMS and RoIAlign."""
