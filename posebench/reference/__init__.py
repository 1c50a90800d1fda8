"""The plain reference: PyTorch in float32, independent of the port.

It imports nothing of ``pytorch_pose_estimation_tpu_torch`` and nothing of
JAX, and works out from the benchmark's own inputs (the seed, the traffic's
arrays, the seeded weights) whatever the program derives from them.
"""
