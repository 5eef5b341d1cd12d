"""The plain float32 reference of the benchmark's cells.

Plain PyTorch only: it imports nothing of the program under test
(``pd_fusion_torch``), of the JAX package or of JAX, and takes nothing the
program made. The benchmark makes the inputs, weights and draws and hands
the same to both sides.
"""
