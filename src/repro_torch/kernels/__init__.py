"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers
(``ops``), their plain PyTorch versions (``ref``) and their build
(``_build``); ``breakdown`` times cut-down copies of the kernels on the
card. Every Pallas kernel of the reference has its counterpart:

  fused_step  — ring-state model-input assembly + the C3 trunk in one
                kernel (replaces repro/kernels/fused_step.py); the SimNet
                engine's kernel path for the ring layout
  cnn_trunk   — the C3 trunk on an assembled input (replaces
                repro/kernels/cnn_trunk.py); the engine's kernel path for
                the roll layout and bf16 state
  conv2s      — one k2s2 conv + bias + ReLU (replaces
                repro/kernels/conv2s.py); the public ``ops.conv2s`` API
  decode_attn — one-token GQA flash-decode in one launch: a copy ring and
                tensor-core MMAs, the splits of the KV length merged by
                their last block (replaces repro/kernels/decode_attn.py);
                the LM decode path, ``decode_step(..., use_kernel=True)``

and one kernel pair the port adds for a ``lax.scan`` of the reference:

  wkv         — rwkv6's wkv recurrence, forward and backward
                (``ops.wkv``, one dispatcher op; the reference's scan in
                repro/nn/ssm.py::rwkv_timemix); the rwkv prefill and
                train step
"""
