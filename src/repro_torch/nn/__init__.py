"""Neural-network substrate of the LM zoo in PyTorch — the port of
``repro.nn``.

* Parameters are nested dicts of tensors with the reference's names and
  layouts (a dense kernel is (in, out), used as ``x @ w``).
* Every ``init_*`` draws from an explicit ``torch.Generator`` and returns
  the params alone (``ShardSpec`` is in ``nn.init``; the families'
  ``ShardSpec`` trees come with the LM half of the mesh).
* Compute dtype is taken from the config (bf16 by default).
* Ported so far: init, layers, rope, attention and the dense transformer
  block; moe and ssm come with their families.
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
