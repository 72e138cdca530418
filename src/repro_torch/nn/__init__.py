"""Neural-network substrate of the LM zoo in PyTorch — the port of
``repro.nn``.

* Parameters are nested dicts of tensors with the reference's names and
  layouts (a dense kernel is (in, out), used as ``x @ w``).
* Every ``*_params`` initialiser draws from an explicit
  ``torch.Generator`` and returns the params alone; the ``*_specs``
  function beside it gives their ``ShardSpec`` tree (``nn.init``).
* Compute dtype is taken from the config (bf16 by default).
* Modules: init, layers, rope, attention, the transformer block, moe and
  ssm.
"""
from repro_torch.nn.init import dense_init, embed_init, scalar_init
from repro_torch.nn import layers, rope, attention, transformer

__all__ = [
    "dense_init",
    "embed_init",
    "scalar_init",
    "layers",
    "rope",
    "attention",
    "transformer",
]
