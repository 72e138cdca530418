"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers
(``ops``), their plain PyTorch versions (``ref``) and their build
(``_build``):

  fused_step — ring-state model-input assembly + the C3 trunk in one
               kernel (replaces repro/kernels/fused_step.py)
  cnn_trunk  — the C3 trunk on an assembled input (replaces
               repro/kernels/cnn_trunk.py)
"""
