"""Tensor-parallel prefill and decode over ``"model"`` (with the data axes
beside it), run by both packages.

The reference jits ``transformer.prefill`` and ``transformer.decode_step``
as its ``launch/dryrun.py`` compiles them: the parameters placed by
``shardings.param_specs``, the caches by ``shardings.cache_specs``, the
inputs by ``batch_specs``, and ``runtime_config``'s knobs (``RUNTIME``:
``kv_cache_blocks`` the ``"model"`` extent, ``moe_groups`` the device
count).  ``dryrun.py`` itself forces 512 devices at import, so this module
applies the knobs and the shardings itself.  ONE subprocess per world
(``run_jax``: forced host devices, Auto-axis meshes) writes, per case, the
parameters and inputs, the prefill logits and caches, the logits and
caches of ``STEPS`` decode steps fed the greedy tokens, and the greedy
tokens of ``lm.greedy_generate``'s chain (the prefill's and the decode
steps' argmaxes; a vision-language model's, whose prefill above starts
from ``input_embeds``, from ``lm.greedy_generate`` itself on the token
prompt, mesh-free).  The ``EP_CASE`` installs
``models.shard_ctx`` as ``dryrun.py`` installs it: there the oracle is the
mesh-free prefill whose MoE blocks dispatch each device's (batch block,
sequence block) as one group (the tokens permuted, as ``ep_scenarios``
does), and the reference's decode step raises.

The port runs every case in a ``gloo`` world of spawned ranks
(``torch_rank``) under the groups ``train(mesh=...)`` installs: each rank
holds its ``"model"`` slices of the reference's parameters
(``weights.model_slices``) and its data rows, allocates its cache pieces
(``transformer.init_caches``), prefills, decodes with the reference's
tokens, decodes again from the reference's prefill cache carried across
(``weights.cache_piece``), and generates greedily.

This module imports neither JAX nor torch at import time.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

BATCH, SEQ, MAX_LEN, STEPS, ENC_SEQ, SEED = 4, 16, 24, 3, 8, 0
AXES = ("data", "model")

#: the registry's ids, in ``configs.registry.ARCH_IDS`` order
ARCHS = ("gemma-7b", "internlm2-20b", "granite-34b", "gemma3-4b", "olmoe-1b-7b",
         "deepseek-moe-16b", "hymba-1.5b", "rwkv6-1.6b", "qwen2-vl-2b",
         "seamless-m4t-large-v2")
#: the expert-parallel case: olmoe-1b-7b on (1, 2), shard_ctx installed
EP_CASE = "olmoe-1b-7b_ep_1x2"
#: the padded-vocabulary case: 256 tokens padded to 384 columns, so that
#: rank 1's half of the head holds 64 real columns and 128 padding ones
PAD_CASE = "gemma-7b_pad384_1x2"
#: the whole-cache case: one KV block, which cache_specs leaves whole on
#: every "model" rank (1 block over 4 ranks does not divide)
WHOLE_CASE = "gemma-7b_blocks1_1x4"
#: case -> (arch, mesh shape, runtime overrides); axes ("data", "model")
CASES = {
    **{f"{a}_1x2": (a, (1, 2), {}) for a in ARCHS},
    EP_CASE: ("olmoe-1b-7b", (1, 2), {}),
    PAD_CASE: ("gemma-7b", (1, 2), {"vocab_pad": 384}),
    WHOLE_CASE: ("gemma-7b", (1, 4), {"kv_cache_blocks": 1}),
    **{f"{a}_2x2": (a, (2, 2), {}) for a in ("gemma-7b", "olmoe-1b-7b", "qwen2-vl-2b",
                                             "seamless-m4t-large-v2")},
    "internlm2-20b_1x4": ("internlm2-20b", (1, 4), {}),
    "granite-34b_1x4": ("granite-34b", (1, 4), {}),
}
#: world -> (ranks, the cases that run there); a world per test file, two
#: or three cases each, so that each file's reference subprocess (its
#: compiles take most of a world's time) and ranks stay well inside its time
WORLDS = {
    "dense": (2, ("gemma-7b_1x2", "internlm2-20b_1x2", "granite-34b_1x2")),
    "vlm": (2, ("gemma3-4b_1x2", "qwen2-vl-2b_1x2")),
    "moe": (2, ("olmoe-1b-7b_1x2", "deepseek-moe-16b_1x2", EP_CASE)),
    "families": (2, ("hymba-1.5b_1x2", "rwkv6-1.6b_1x2")),
    "encdec": (2, ("seamless-m4t-large-v2_1x2", PAD_CASE)),
    "mesh": (4, ("gemma-7b_2x2", "olmoe-1b-7b_2x2")),
    "mesh_inputs": (4, ("qwen2-vl-2b_2x2", "seamless-m4t-large-v2_2x2")),
    "wide": (4, ("internlm2-20b_1x4", "granite-34b_1x4", WHOLE_CASE)),
}


def runtime(name) -> dict:
    """``launch/dryrun.py``'s ``runtime_config`` knobs on the case's
    (data, model) mesh for a prefill or decode cell, and its overrides."""
    _arch, shape, over = CASES[name]
    return {"kv_cache_blocks": shape[1], "moe_groups": shape[0] * shape[1],
            "dense_attn_threshold": 8192, "attn_block_k": 1024, "vocab_pad": 256, **over}


def inputs(cfg) -> dict:
    """The case's inputs, numpy, from ``SEED``: ``tokens`` (B, S) always
    (the greedy prompt); a vision-language model's prefill takes
    ``input_embeds`` (B, S, d) and M-RoPE ``positions`` (3, B, S) (a 4 x 4
    image's h and w streams) instead; an encoder-decoder's also
    ``enc_embeds`` (B, ENC_SEQ, d)."""
    rng = np.random.default_rng(SEED)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    if cfg.family == "vlm":
        out["input_embeds"] = (rng.standard_normal((BATCH, SEQ, cfg.d_model))
                               * 0.02).astype(np.float32)
        s = np.arange(SEQ)
        out["positions"] = np.broadcast_to(np.stack([s, s // 4, s % 4])[:, None],
                                           (3, BATCH, SEQ)).astype(np.int32).copy()
    if cfg.encdec:
        out["enc_embeds"] = rng.standard_normal((BATCH, ENC_SEQ, cfg.d_model)).astype(np.float32)
    return out


def prefill_inputs(cfg, inp: dict) -> dict:
    """What ``prefill`` takes of ``inputs``."""
    if cfg.family == "vlm":
        return {"input_embeds": inp["input_embeds"], "positions": inp["positions"]}
    keys = ("tokens", "enc_embeds") if cfg.encdec else ("tokens",)
    return {k: inp[k] for k in keys}


# ---------------------------------------------------------------------------
# The reference: one subprocess per world
# ---------------------------------------------------------------------------


def _port_cache(c):
    """A reference decode state of numpy leaves in the port's named tuples
    (told apart by their fields), which the ranks unpickle without JAX."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.rwkv import RWKVState
    from repro_torch.models.ssm import SSMState
    if isinstance(c, dict):
        return {k: _port_cache(v) for k, v in c.items()}
    cls = {t._fields: t for t in (KVCache, SSMState, RWKVState)}[c._fields]
    return cls(*(np.asarray(x) for x in c))


def _jax_case(name) -> dict:
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs.registry import get_smoke_config
    from repro.launch import shardings as shd
    from repro.models import lm, mlp, shard_ctx
    from repro.models import transformer as tfm
    import ep_scenarios as EP
    from sharded_scenarios import jax_mesh
    from zero1_scenarios import _flat_np
    arch, shape, _over = CASES[name]
    cfg = get_smoke_config(arch).with_runtime(dtype=jnp.float32, **runtime(name))
    params = jax.jit(tfm.init_model, static_argnums=1)(jax.random.PRNGKey(SEED), cfg)
    inp = inputs(cfg)
    batch = {k: jnp.asarray(v) for k, v in prefill_inputs(cfg, inp).items()}
    mesh = jax_mesh(shape, AXES)
    ns = lambda spec: NamedSharding(mesh, spec)
    bspec = "data" if BATCH % shape[0] == 0 else None
    p_sh = shd.named(shd.param_specs(jax.eval_shape(lambda: params), mesh), mesh)
    c_aval = jax.eval_shape(functools.partial(tfm.init_caches, cfg, BATCH, MAX_LEN))
    c_sh = shd.named(shd.cache_specs(c_aval, mesh, cfg), mesh)
    b_sh = shd.named(shd.batch_specs(jax.eval_shape(lambda: batch), mesh), mesh)
    enc_out = (jax.jit(functools.partial(tfm.encode, cfg=cfg))(params, batch["enc_embeds"])
               if cfg.encdec else None)

    def decode(p, t, c, e):
        return tfm.decode_step(p, cfg, t, c, enc_out=e)
    dec_in = (p_sh, ns(P(bspec, None)), c_sh, ns(P(bspec, None, None)) if cfg.encdec else None)
    decode_jit = jax.jit(decode, in_shardings=dec_in, out_shardings=(ns(P(bspec)), c_sh))
    res = {"params": _flat_np(params), "inputs": inp}
    if name == EP_CASE:
        # the oracle: mesh-free, each device's (batch block, sequence block)
        # one MoE group (the tokens permuted, as ep_scenarios' oracle)
        real = mlp.moe_block

        def grouped(p, x, cfg_):
            out, aux = real(p, EP.permute(x, shape), cfg_)
            return EP.unpermute(out, shape, x.shape[0], x.shape[1]), aux
        mlp.moe_block = grouped
        try:
            logits, caches = jax.jit(lambda p, b, c: tfm.prefill(p, cfg, caches=c, **b))(
                params, batch, tfm.init_caches(cfg, BATCH, MAX_LEN))
        finally:
            mlp.moe_block = real
        EP.jax_install(mesh, cfg, BATCH)
        try:
            with jax.set_mesh(mesh):
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
                decode_jit(jax.device_put(params, p_sh), jax.device_put(tok, dec_in[1]),
                           jax.device_put(caches, c_sh), None)
            res["decode_error"] = None
        except ValueError as e:
            res["decode_error"] = str(e)
        finally:
            shard_ctx.clear()
        res.update(prefill_logits=np.asarray(logits), prefill_cache=_port_cache(
            jax.tree_util.tree_map(np.asarray, caches)))
        return res

    prefill_jit = jax.jit(lambda p, b, c: tfm.prefill(p, cfg, caches=c, **b),
                          in_shardings=(p_sh, b_sh, c_sh), out_shardings=(ns(P(bspec)), c_sh))
    with jax.set_mesh(mesh):
        placed = jax.device_put(params, p_sh)
        logits, caches = prefill_jit(placed, jax.device_put(batch, b_sh),
                                     jax.device_put(tfm.init_caches(cfg, BATCH, MAX_LEN), c_sh))
        res["prefill_logits"] = np.asarray(logits)
        res["prefill_cache"] = _port_cache(jax.tree_util.tree_map(np.asarray, caches))
        tokens, steps = [], []
        for _ in range(STEPS):
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            logits, caches = decode_jit(placed, jax.device_put(tok, dec_in[1]), caches,
                                        None if enc_out is None
                                        else jax.device_put(enc_out, dec_in[3]))
            tokens.append(np.asarray(tok))
            steps.append(np.asarray(logits))
    res.update(tokens=tokens, decode_logits=steps,
               decode_cache=_port_cache(jax.tree_util.tree_map(np.asarray, caches)))
    if cfg.family == "vlm":              # its chain above starts from input_embeds
        res["greedy"] = np.asarray(jax.jit(lambda p, t: lm.greedy_generate(p, cfg, t, STEPS + 1))(
            params, jnp.asarray(inp["tokens"])))
    elif not cfg.encdec:                 # lm.greedy_generate's chain: the argmaxes above
        res["greedy"] = np.concatenate(
            tokens + [np.asarray(jnp.argmax(logits[:, -1], -1)[:, None])], 1).astype(np.int32)
    return res


def run_jax(world: str, out_path: str) -> None:
    import warnings
    warnings.filterwarnings("ignore")
    # smoke shapes: no Eigen thread pool, beside the suite's other workers
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = f"{flags} --xla_cpu_multi_thread_eigen=false"
    results = {name: _jax_case(name) for name in WORLDS[world][1]}
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The port: a gloo world of spawned ranks
# ---------------------------------------------------------------------------


def torch_cfg(name):
    import torch
    from repro_torch.configs.registry import get_smoke_config
    arch, _shape, _over = CASES[name]
    return get_smoke_config(arch).with_runtime(dtype=torch.float32, **runtime(name))


def _numpy(tree):
    """A copy: ``cache_to_numpy`` shares a CPU tensor's storage, which the
    next step writes in place."""
    from repro_torch.models import weights
    host = weights.cache_to_numpy(tree)
    if isinstance(host, dict):
        return {k: _numpy_copy(v) for k, v in host.items()}
    return _numpy_copy(host)


def _numpy_copy(nt):
    return type(nt)(*(np.array(x, copy=True) for x in nt))


def _torch_case(name, ref) -> dict:
    import torch
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import data_parallel, lm, shard_ctx, tensor_parallel, weights
    from repro_torch.models import transformer as tfm
    import ep_scenarios as EP
    _arch, shape, _over = CASES[name]
    cfg = torch_cfg(name)
    r = ref[name]
    mesh = make_mesh(shape, AXES, "cpu")
    dg, mg = T.data_group(mesh), T.tp_group(mesh)
    whole = weights.from_numpy(weights.unflatten(r["params"]), cfg, "cpu")
    params = weights.model_slices(whole, shd.model_dims(whole, mesh), mg.index, mg.size)
    del whole
    rows = lambda a, dim=0: dg.local_rows(torch.from_numpy(np.asarray(a)), dim)
    batch = {k: rows(v, 1 if k == "positions" else 0)
             for k, v in prefill_inputs(cfg, r["inputs"]).items()}
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate()), "rows": dg.index}
    with data_parallel.use(dg), tensor_parallel.use(mg):
        params = tensor_parallel.serving_view(params, cfg)
        tensor_parallel.reset_serving_bytes()
        caches = tfm.init_caches(cfg, BATCH, MAX_LEN, device="cpu")
        out["local_shapes"] = [tuple(t.shape) for t in _leaves(caches)]
        if name == EP_CASE:
            EP.install(mesh, cfg, BATCH)
            try:
                logits, caches = tfm.prefill(params, cfg, caches=caches, **batch)
                out.update(prefill_logits=logits.numpy(), prefill_cache=_numpy(caches))
                tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
                try:
                    tfm.decode_step(params, cfg, tok, caches)
                    out["decode_error"] = None
                except ValueError as e:
                    out["decode_error"] = str(e)
            finally:
                shard_ctx.clear()
            return out
        logits, caches = tfm.prefill(params, cfg, caches=caches, **batch)
        out.update(prefill_logits=logits.numpy(), prefill_cache=_numpy(caches),
                   prefill_bytes=dict(tensor_parallel.serving_bytes))
        enc = tfm.encode(params, batch["enc_embeds"], cfg) if cfg.encdec else None
        steps = []
        for tok in r["tokens"]:
            logits, caches = tfm.decode_step(params, cfg, rows(tok), caches, enc_out=enc)
            steps.append(logits.numpy())
        out.update(decode_logits=steps, decode_cache=_numpy(caches))
        # decode alone: from the reference's prefill cache, carried across
        caches = weights.cache_piece(r["prefill_cache"], cfg, mesh, out["coord"], "cpu")
        steps = []
        for tok in r["tokens"]:
            logits, caches = tfm.decode_step(params, cfg, rows(tok), caches, enc_out=enc)
            steps.append(logits.numpy())
        out.update(alone_logits=steps, alone_cache=_numpy(caches))
        if cfg.encdec:
            try:
                lm.greedy_generate(params, cfg, rows(r["inputs"]["tokens"]), STEPS + 1)
                out["greedy_error"] = None
            except AttributeError as e:
                out["greedy_error"] = type(e).__name__
        else:
            out["greedy"] = lm.greedy_generate(params, cfg, rows(r["inputs"]["tokens"]),
                                               STEPS + 1).numpy()
    out["bytes"] = dict(tensor_parallel.serving_bytes)
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return list(tree)


def torch_rank(rank: int, world: str, store_path: str, out_dir: str, ref_path: str,
               timeout_s: float) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)             # smoke shapes, beside the suite's other workers
    size, cases = WORLDS[world]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        results = {name: _torch_case(name, ref) for name in cases}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":          # the JAX side: world out_path
    run_jax(sys.argv[1], sys.argv[2])
