"""The port's training path against the JAX package: the train step, the
token pipeline, checkpoints and ``train()`` with resume, on the CPU at the
gemma-7b smoke config (2 layers, d 64, vocab 256).

Tolerances: losses over three training steps rtol 1e-4 (float32; the
parameters drift by ulps step over step); tokens bit for bit; checkpoints
exact (bfloat16 round-trips through float32 files without loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_7b as jgemma
from repro.data.pipeline import DataPipeline as JPipeline
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import gemma_7b as tgemma
from repro_torch.data.pipeline import DataPipeline, TokenSource
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import weights
from repro_torch.optim import adamw
from repro_torch.runtime import fault


def test_three_train_steps_match_jax():
    jcfg = jgemma.smoke_config().with_runtime(dtype=jnp.float32)
    tcfg = tgemma.smoke_config().with_runtime(dtype=torch.float32)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=12)
    params = jtfm.init_model(jax.random.PRNGKey(0), jcfg)
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    jpipe = JPipeline(jcfg, batch=2, seq=16, seed=0)
    tpipe = DataPipeline(tcfg, batch=2, seq=16, seed=0, device="cpu")

    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg)))
    jstate, jocfg = jadamw.init(params), jadamw.AdamWConfig(**ocfg)
    step_fn = ttrain.make_train_step(tcfg, adamw.AdamWConfig(**ocfg))
    tstate = adamw.init(weights.leaves(model))
    jl, tl = [], []
    for step in range(3):
        loss, grads = grad_fn(params, jpipe.batch_for_step(step))
        params, jstate, _ = jadamw.update(params, grads, jstate, jocfg)
        jl.append(float(loss))
        tstate, metrics = step_fn(model, tstate, tpipe.batch_for_step(step))
        tl.append(float(metrics["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] and int(tstate.step) == 3
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("use_mozart", [True, False])
def test_tokens_equal_jax_bit_for_bit(use_mozart):
    """Steps whose raw Zipf draws overflow int32 included: the wrap of the
    int64 draws to int32 before the modulo is the JAX pipeline's (with
    ``use_mozart`` False both reduce the int64 draws directly)."""
    jcfg, tcfg = jgemma.smoke_config(), tgemma.smoke_config()
    kw = dict(batch=4, seq=255, seed=0, use_mozart=use_mozart)
    jpipe, tpipe = JPipeline(jcfg, **kw), DataPipeline(tcfg, **kw, device="cpu")
    src = TokenSource(tcfg.vocab_size, seed=0)
    wrapped = 0
    for step in range(4):
        raw = src.batch_at(step, 4, 255)
        wrapped += int((raw > np.iinfo(np.int32).max).sum())
        got = tpipe.batch_for_step(step)["tokens"]
        want = np.asarray(jpipe.batch_for_step(step)["tokens"])
        assert got.dtype == torch.int32 and got.shape == (4, 256)
        np.testing.assert_array_equal(got.numpy(), want)
    assert wrapped > 0


def test_prefetch_iterator_yields_steps_in_order():
    pipe = DataPipeline(tgemma.smoke_config(), batch=2, seq=8, seed=3, device="cpu")
    seen = []
    for step, b in pipe.iterate(5):
        assert torch.equal(b["tokens"], pipe.batch_for_step(step)["tokens"])
        seen.append(step)
        if len(seen) == 3:
            break
    pipe.stop()
    assert seen == [5, 6, 7] and pipe._thread is None


def test_checkpoint_round_trip_is_exact(tmp_path):
    cfg = tgemma.smoke_config()
    model = ttrain.tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    state = adamw.init(weights.leaves(model))
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    ckpt.save(tmp_path, 7, {"params": model, "opt": state}, meta={"arch": cfg.name})
    (tmp_path / "step_00000009.tmp").mkdir()            # an unfinished write
    assert ckpt.latest_step(tmp_path) == 7
    assert ckpt.load_meta(tmp_path, 7)["arch"] == cfg.name
    other = ttrain.tfm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    back = ckpt.restore(tmp_path, 7, {"params": other.tree(),
                                      "opt": adamw.init(weights.leaves(other))})
    for name, t in weights.flatten(back["params"]).items():
        want = weights.leaves(model)[name]
        assert t.dtype == want.dtype and torch.equal(t, want), name
    assert isinstance(back["opt"], adamw.AdamWState) and int(back["opt"].step) == 7
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, 9, {"x": torch.zeros(1)})


def test_async_checkpointer_keeps_the_last(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep_last=2)
    for s in (1, 2, 3):
        saver.save_async(s, {"x": torch.full((3,), float(s))})
    saver.wait()
    assert ckpt.all_steps(tmp_path) == [2, 3] and saver.saved == [1, 2, 3]


def test_train_runs_checkpoints_and_resumes(tmp_path):
    cfg = tgemma.smoke_config()
    kw = dict(batch=2, seq=16, ckpt_dir=str(tmp_path), device="cpu", log_every=1)
    first = ttrain.train(cfg, steps=3, **kw)
    assert len(first["losses"]) == 3 and np.all(np.isfinite(first["losses"]))
    assert ckpt.latest_step(tmp_path) == 3
    saved = weights.leaves(first["params"])

    second = ttrain.train(cfg, steps=5, **kw)
    assert len(second["losses"]) == 2 and ckpt.latest_step(tmp_path) == 5
    # the resumed run started from the saved state, at step 3's batch
    model = ttrain.tfm.init_model(cfg, torch.Generator().manual_seed(9), "cpu")
    weights.assign(model, {n: p.detach().clone() for n, p in saved.items()})
    with torch.no_grad():
        loss = tlm.loss_fn(model, DataPipeline(cfg, 2, 16, device="cpu").batch_for_step(3), cfg)
    np.testing.assert_allclose(second["losses"][0], float(loss), rtol=1e-6)


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.train(tgemma.smoke_config(), steps=1, batch=1, seq=4)


class TestFault:
    def test_retry_then_success(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return 42

        assert fault.with_retries(flaky, retries=3) == 42 and calls["n"] == 3

    def test_retry_exhaustion_raises_and_bugs_propagate(self):
        with pytest.raises(fault.StepFailure):
            fault.with_retries(lambda: (_ for _ in ()).throw(RuntimeError("x")),
                               retries=2)
        with pytest.raises(KeyError):
            fault.with_retries(lambda: {}["missing"], retries=2)

    def test_straggler_detection(self):
        t = fault.StepTimer(fault.FaultConfig(min_steps_for_baseline=3,
                                              straggler_factor=2.0))
        for i in range(6):
            t.record(i, 0.1)
        assert t.record(6, 0.5) is True and 6 in t.stragglers
        assert t.record(7, 0.11) is False

    def test_restart_loop_resumes_from_checkpoint(self, tmp_path):
        state_log = []
        crashes = {"n": 0}

        def make_state(step):
            start = step if step is not None else 0
            return {"x": start}, start

        def run_from(state, start):
            for s in range(start, 10):
                if s == 5:
                    ckpt.save(tmp_path, 5, {"x": torch.tensor(5)})
                if s == 7 and crashes["n"] == 0:
                    crashes["n"] += 1
                    raise RuntimeError("host died")
                state_log.append(s)
            return "done"

        out = fault.run_with_restarts(
            make_state, run_from, fault_cfg=fault.FaultConfig(),
            latest_step=lambda: ckpt.latest_step(tmp_path))
        assert out == "done" and state_log.count(0) == 1 and state_log.count(5) == 2


def test_moe_train_checkpoints_and_resumes_with_pre_layers(tmp_path):
    """deepseek-moe's smoke config on the CPU (a dense pre-layer: a list in
    the parameter tree, saved as ``params/pre_layers/0/...``): two steps,
    a checkpoint, and a resumed third step from it."""
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config("deepseek-moe-16b")
    kw = dict(batch=2, seq=16, ckpt_dir=str(tmp_path), device="cpu", log_every=1)
    first = ttrain.train(cfg, steps=2, **kw)
    assert len(first["losses"]) == 2 and np.all(np.isfinite(first["losses"]))
    keys = ckpt.load_meta(tmp_path, 2)["keys"]
    assert "params/pre_layers/0/mlp/w_in" in keys and "params/layers/moe/router" in keys
    second = ttrain.train(cfg, steps=3, **kw)
    assert len(second["losses"]) == 1 and ckpt.latest_step(tmp_path) == 3
    model = ttrain.tfm.init_model(cfg, torch.Generator().manual_seed(9), "cpu")
    back = ckpt.restore(tmp_path, 2, {"params": model.tree()})["params"]
    assert isinstance(back["pre_layers"], list)
    saved = {n: p.detach().clone() for n, p in weights.flatten(back).items()}
    weights.assign(model, saved)
    with torch.no_grad():
        loss = tlm.loss_fn(model, DataPipeline(cfg, 2, 16, device="cpu").batch_for_step(2), cfg)
    np.testing.assert_allclose(second["losses"][0], float(loss), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_embedding_input_families_train_checkpoint_and_resume(arch, tmp_path):
    """The qwen2-vl smoke config (``input_embeds`` and M-RoPE positions from
    the pipeline; the token embedding unused, so its gradient is zeros) and
    the seamless one (``enc_embeds``; encoder, ``cross`` and ``ln3``
    leaves), float32 as the reference's ``TestTrainDriver``: two steps, a
    checkpoint, and a resumed third step from it whose loss is the saved
    model's on step 2's batch."""
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config(arch).with_runtime(dtype=torch.float32)
    kw = dict(batch=2, seq=16, ckpt_dir=str(tmp_path), device="cpu", log_every=1)
    first = ttrain.train(cfg, steps=2, **kw)
    assert len(first["losses"]) == 2 and np.all(np.isfinite(first["losses"]))
    assert ckpt.latest_step(tmp_path) == 2
    second = ttrain.train(cfg, steps=3, **kw)
    assert len(second["losses"]) == 1 and ckpt.latest_step(tmp_path) == 3
    model = ttrain.tfm.init_model(cfg, torch.Generator().manual_seed(9), "cpu")
    back = ckpt.restore(tmp_path, 2, {"params": model.tree()})["params"]
    weights.assign(model, {n: p.detach().clone() for n, p in weights.flatten(back).items()})
    with torch.no_grad():
        loss = tlm.loss_fn(model, DataPipeline(cfg, 2, 16, device="cpu").batch_for_step(2), cfg)
    np.testing.assert_allclose(second["losses"][0], float(loss), rtol=1e-6)
    if arch == "qwen2-vl-2b":        # the unused embedding: zero gradient, decay only
        init = ttrain.tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        assert torch.allclose(back["embed"], init["embed"].detach(), rtol=1e-2)
