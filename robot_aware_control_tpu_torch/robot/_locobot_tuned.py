"""Locobot capsule radii tuned on the seed-0 IK pose set against MuJoCo
segmentation renders of the reference locobot{,_thick}.xml, with held-out
fidelity on the disjoint seed-1 set (generated in the JAX package by
benchmarks/mask_fidelity.py --tune --robots locobot)."""

LOCOBOT_RADII = [0.045, 0.041, 0.028, 0.042]
LOCOBOT_BASE_RADII = [0.1, 0.1, 0.08, 0.025]
THICK_SCALE = 1.0
