"""The plain reference the benchmark holds the program against.

Frozen from ``rpg_open_remode_tpu_torch`` at the commit that added the
benchmark: the keyframe reseed, the frame step (classify, rectified match
with its pure-rotation and plane-sweep fallbacks, triangulation, fusion) and
the TV-L1 denoise, each as the plain PyTorch version of its kernel (the
sweep, the two-pass warp and the TV-L1 loop as whole-image tensor ops). It
imports nothing of the program, so a change to the program cannot move it.
``engine.replay_keyframe`` recomputes one keyframe from the raw frames,
poses, bounds and switch frames.
"""
