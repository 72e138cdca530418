"""The port's counted FLOPs against the reference's, on the CPU: for one
arch of every family at reduced width in f32, one unsharded decode step
(on a full cache, so K4's live positions are the whole cache the plain
XLA attention computes) and one train step, and one c3 chunk of 128
lanes × 64 steps (`SimNetEngine.lower`), the port's `OpCounter` is within
1% of ``repro.runtime.hlo.analyze`` of the reference's compiled function
on one CPU device, with the same weights (the reference's ``init``,
crossed over as numpy arrays) and inputs.

Bytes are not compared: XLA fuses elementwise chains and counts each
fusion's boundary, while the port counts what each of its ops moves (a
c3 chunk: 5.65e8 bytes in the port's count against 1.96e9 in the
reference's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models.registry import build_model as ref_build_model  # noqa: E402
from repro.runtime import hlo  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_train_loop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.launch.train import extras_for  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime.opcount import analyze  # noqa: E402
from repro_torch.training import optimizer, train_loop  # noqa: E402

FAMILY_ARCHS = ("tinyllama-1.1b", "mixtral-8x7b", "qwen2-vl-72b", "recurrentgemma-2b",
                "whisper-large-v3", "rwkv6-1.6b")
B, T, S = 4, 16, 32
RTOL = 0.01


def _models(arch):
    rcfg = ref_reduced(REF_ARCHS[arch], dtype="float32")
    rm = ref_build_model(rcfg)
    rparams, _ = rm.init(jax.random.PRNGKey(3))
    model = build_model(reduced(registry.ARCHS[arch], dtype="float32"))
    return rm, rparams, model, jax.tree_util.tree_map(np.asarray, rparams)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_step_flops_equal_the_reference(arch):
    rm, rparams, model, params_np = _models(arch)
    token = np.arange(B, dtype=np.int32)
    compiled = jax.jit(rm.decode_step).lower(rparams, rm.init_decode_state(B, S),
                                             jnp.asarray(token)).compile()
    want = hlo.analyze(compiled.as_text())["flops"]
    state = model.init_decode_state(B, S, device="cpu")
    state["pos"] = torch.tensor(S - 1, dtype=state["pos"].dtype)  # a full cache
    with torch.no_grad():
        got = analyze(model.decode_step, model.params_from_numpy(params_np, "cpu"), state,
                      torch.from_numpy(token))
    assert got["flops"] == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_flops_equal_the_reference(arch):
    """Remat's recompute counted on both sides (XLA's HLO holds it)."""
    rm, rparams, model, params_np = _models(arch)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, model.cfg.vocab, (B, T)).astype(np.int32),
             "loss_mask": np.ones((B, T), np.float32)}
    batch.update({k: np.asarray(f(B, T)) for k, f in extras_for(model.cfg).items()})
    step = jax.jit(ref_train_loop.make_train_step(rm, ref_opt.AdamConfig(),
                                                  accum_steps=model.cfg.accum_steps))
    compiled = step.lower(rparams, ref_opt.adam_init(rparams),
                          {k: jnp.asarray(v) for k, v in batch.items()}).compile()
    want = hlo.analyze(compiled.as_text())["flops"]
    params = model.params_from_numpy(params_np, "cpu", masters=True)
    port_step = train_loop.make_train_step(model, optimizer.AdamConfig(),
                                           accum_steps=model.cfg.accum_steps)
    got = analyze(port_step, params, optimizer.adam_init(params),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["flops"] == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "k1"])
def test_c3_chunk_flops_equal_the_reference(use_kernel):
    from repro.core.predictor import PredictorConfig as RefPredictorConfig
    from repro.core.predictor import init_predictor as ref_init_predictor
    from repro.serving.simnet_engine import SimNetEngine as RefSimNetEngine
    from repro_torch.core.predictor import PredictorConfig, params_from_numpy
    from repro_torch.serving.simnet_engine import SimNetEngine

    rparams, _ = ref_init_predictor(jax.random.PRNGKey(0), RefPredictorConfig(kind="c3"))
    compiled = RefSimNetEngine(rparams, RefPredictorConfig(kind="c3")).lower(128, 64).compile()
    want = hlo.analyze(compiled.as_text())
    pcfg = PredictorConfig(kind="c3")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    got = SimNetEngine(params, pcfg, device="cpu", use_kernel=use_kernel).lower(128, 64)
    assert got["flops"] == pytest.approx(want["flops"], rel=RTOL)
    assert got["collectives"]["total_count"] == want["collectives"]["total_count"] == 0
