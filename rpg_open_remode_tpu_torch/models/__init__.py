"""Engine state and the single-keyframe engine."""
