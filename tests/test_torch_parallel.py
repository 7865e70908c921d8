"""The port's multi-GPU layer (`mudg_tpu_torch/parallel/`, the sharded train
step) on the CPU over gloo.

The layouts against JAX's: every leaf's sharded dim (ZeRO, FSDP, the TP
column/row cuts and TP x FSDP) from `jax.eval_shape` trees and JAX's own
sharding functions on the 8-device CPU mesh, mapped to the torch layout (no
compile), and the transformer blocks the port keeps whole for their heads.

Then N ranks against one process on the same weights and inputs (the
single-process path is held against JAX by the parity tests; no JAX runs in
a spawned rank): one spawn of 2 ranks and one of 4 (tests/
torch_parallel_ranks.py) run every check and the tests read their results.
Tolerances, fp32: a UNet forward or sample within 1e-5 (1e-4 for the
2-step sample) of max|ref|; a train step's loss and gradient norm within
1e-5 relative, mu and nu within 1e-5 of their max|ref|, parameters and EMA
within 0.25 x the learning rate (AdamW's first step moves an element by
about the learning rate whatever its gradient, so elements whose gradient
is near 0 carry the summation order's rounding into a visible fraction of
it). Each planted fault (GroupNorm statistics not summed over the seq
ranks, the all-to-all's blocks laid end to end in reverse, the naive [u | g]
column split of the GEGLU projection) must miss the forward's bound.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.models import presets as JP
from mudg_tpu.nn import unet3d as JU
from mudg_tpu.parallel import mesh as JPM
from mudg_tpu.parallel import tp as JTP
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.models import presets as TP_
from mudg_tpu_torch.nn import unet3d as TU
from mudg_tpu_torch.parallel import mesh as PM
from mudg_tpu_torch.parallel import tp as TP

FWD_TOL = 1e-5
SAMPLE_TOL = 1e-4
METRIC_TOL = 1e-5
MOMENT_TOL = 1e-5
PARAM_TOL = 0.25 * R.LR


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _spec_dims(spec, axis):
    """The JAX dims a PartitionSpec gives to `axis`."""
    return [i for i, a in enumerate(spec) if a == axis or (isinstance(a, tuple) and axis in a)]


def _jax_dim(spec, axis):
    dims = _spec_dims(spec, axis)
    assert len(dims) <= 1, spec
    return dims[0] if dims else None


def _torch_shapes(module):
    with torch.device("meta"):
        m = module()
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def unet_trees():
    """(config name, JAX leaf shapes by name, the port's shapes by name) of
    the tiny and the MDM512 UNet."""
    key = jax.random.PRNGKey(0)
    out = []
    for name, jcfg, tcfg in (("tiny", JP.tiny().unet, TP_.tiny().unet),
                             ("mdm512", JU.UNetConfig(), TU.UNetConfig())):
        tree = jax.eval_shape(lambda c=jcfg: JU.init_unet(key, c))
        out.append((name, tree, _torch_shapes(lambda c=tcfg: TU.UNet3D(c))))
    return out


def _mesh(shape, names):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_layout_matches_jax(unet_trees, n_model):
    """JAX's `unet_tp_shardings` on a (data, model) CPU mesh: the port's
    `tp_dim` of every UNet leaf is JAX's 'model' dim mapped to torch's
    (out, in) layout (column: torch dim 0, row: dim 1), and some leaves of
    each kind are cut."""
    mesh = _mesh((8 // n_model, n_model), ("data", "model"))
    for cfg, tree, shapes in unet_trees:
        specs = _flat(JTP.unet_tp_shardings(tree, mesh))
        ours = TP.unet_tp_shardings(shapes, n_model)
        assert set(ours) == set(specs)
        kinds = set()
        for name, sh in specs.items():
            want = PM.torch_dim(name, len(shapes[name]), _jax_dim(sh.spec, "model"))
            assert ours[name] == want, (cfg, name, sh.spec, ours[name])
            kinds.add(want)
        assert kinds == {None, 0, 1}, (cfg, kinds)


def test_tp_whole_heads_and_geglu_layout():
    """The port's cut of MDM512: JAX's layout, less the attention of the
    blocks whose heads do not divide (5 heads at C = 320 under --tp 2; 5
    and 10 at C = 320 and 640 under --tp 4; init_attn's 8 heads divide by
    both), and each feed-forward's net.0.proj cut by GEGLU halves."""
    with torch.device("meta"):
        unet = TU.UNet3D(TU.UNetConfig())
    shapes = {k: tuple(p.shape) for k, p in unet.named_parameters()}
    heads = {n: blk.heads for n, blk in TP._blocks(unet)}
    for n_model, whole in ((2, {5}), (4, {5, 10})):
        replicated = TP.replicated_for_heads(unet, n_model)
        assert replicated == [n for n, h in heads.items() if h in whole]
        assert replicated and "init_attn.0.transformer_blocks.0" not in replicated
        layout = TP.unet_tp_layout(unet, n_model)
        jax_dims = TP.unet_tp_shardings(shapes, n_model)
        for name, d in jax_dims.items():
            if d is None:
                assert name not in layout
                continue
            blk = name.split(".attn")[0] if ".attn" in name else None
            if blk in replicated:
                assert name not in layout, name
            else:
                assert layout[name][0] == d, name
        modes = {m for _, m in layout.values()}
        assert modes == {TP.COLUMN, TP.ROW, TP.GEGLU}
        assert all(m == TP.GEGLU for k, (_, m) in layout.items() if k.endswith("net.0.proj.weight"))


def test_geglu_rows_hold_matching_halves():
    """Rank i of n holds rows [u_i | g_i] of [u | g], and the gather puts
    the blocks back in order; the naive contiguous cut does not."""
    full = torch.arange(16.0)[:, None].expand(16, 3).contiguous()
    n = 4
    blocks = [TP.local_block(full, 0, TP.GEGLU, n, i) for i in range(n)]
    for i, b in enumerate(blocks):
        u, g = b.chunk(2)
        assert torch.equal(u[:, 0], torch.arange(2 * i, 2 * i + 2.0))
        assert torch.equal(g[:, 0], 8 + torch.arange(2 * i, 2 * i + 2.0))
    parts = torch.cat(blocks)
    half = parts.shape[0] // n // 2
    pieces = parts.split(half)
    assert torch.equal(torch.cat(list(pieces[0::2]) + list(pieces[1::2])), full)


@pytest.mark.parametrize("n_model,n_data", [(2, 4), (4, 2)])
def test_tp_fsdp_layout_matches_jax(unet_trees, n_model, n_data):
    """JAX's `unet_tp_fsdp_shardings`: each leaf's 'model' and 'data' dims,
    mapped to torch, equal the port's."""
    mesh = _mesh((n_data, n_model), ("data", "model"))
    for cfg, tree, shapes in unet_trees:
        specs = _flat(JTP.unet_tp_fsdp_shardings(tree, mesh))
        ours = TP.unet_tp_fsdp_shardings(shapes, n_model, n_data)
        cut = 0
        for name, sh in specs.items():
            nd = len(shapes[name])
            want = (PM.torch_dim(name, nd, _jax_dim(sh.spec, "model")),
                    PM.torch_dim(name, nd, _jax_dim(sh.spec, "data")))
            assert ours[name] == want, (cfg, name, sh.spec, ours[name])
            cut += want[1] is not None
        assert cut


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero_dims_match_jax(unet_trees, n):
    """`largest_divisible_axis_spec` with shard_tree_zero's 2**14 floor, on
    every UNet leaf: the port's `zero_dim` is JAX's dim mapped to torch
    (ties between equal dims go to JAX's first, whatever the torch order)."""
    for cfg, tree, shapes in unet_trees:
        for name, leaf in _flat(tree).items():
            if int(np.prod(leaf.shape)) < PM.MIN_SIZE:
                want = None
            else:
                want = PM.torch_dim(name, leaf.ndim, _jax_dim(
                    JPM.largest_divisible_axis_spec(leaf.shape, n, "data"), "data"))
            assert PM.zero_dim(name, shapes[name], n) == want, (cfg, name, leaf.shape)


def test_shard_tree_zero_of_the_train_state_matches_jax():
    """JAX's own `shard_tree_zero` (placed on a 4-device 'data' mesh) over
    the tiny MDM's whole tree, towers included (the FSDP layout), against
    the port's `shard_tree_zero` on the torch shapes."""
    cfg = JP.tiny()
    tree = jax.eval_shape(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg))
    arrays = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    mesh = _mesh((4,), ("data",))
    placed = _flat(JPM.shard_tree_zero(arrays, mesh, "data"))
    shapes = _torch_shapes(lambda: TMDM.MDM(TP_.tiny()))
    ours = PM.shard_tree_zero(shapes, 4)
    assert set(ours) == set(placed)
    for name, x in placed.items():
        assert ours[name] == PM.torch_dim(name, x.ndim, _jax_dim(x.sharding.spec, "data")), name
    assert sum(d is not None for d in ours.values()) > 10


def test_jax_layout_map():
    """jax_shape / torch_dim on the leaf kinds: Linear, ConvNd, in_proj,
    the token embedding, norms."""
    assert PM.jax_shape("a.to_q.weight", (8, 4)) == (4, 8)
    assert PM.jax_shape("a.conv.weight", (8, 4, 3, 3)) == (3, 3, 4, 8)
    assert PM.jax_shape("a.c.weight", (8, 4, 3, 1, 1)) == (3, 1, 1, 4, 8)
    assert PM.jax_shape("a.c.weight", (8, 4, 1)) == (1, 4, 8)
    assert PM.jax_shape("a.in_proj_weight", (12, 4)) == (4, 12)
    assert PM.jax_shape("token_embedding.weight", (10, 4)) == (10, 4)
    assert PM.jax_shape("norm.weight", (4,)) == (4,)
    assert PM.torch_dim("a.conv.weight", 4, 0) == 2 and PM.torch_dim("a.conv.weight", 4, 3) == 0
    assert PM.block(5, 2, 0) == (0, 3) and PM.block(5, 2, 1) == (3, 5)


# ---------------------------------------------------------------------------
# N ranks against one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    refs = R.make_refs(str(tmp / "refs.pt"), 2)
    return R.spawn(R.checks_world2, 2, tmp, refs)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    refs = R.make_refs(str(tmp / "refs.pt"), 4)
    return R.spawn(R.checks_world4, 4, tmp, refs)


def _assert_step(res):
    m, ref = res["metrics"], res["ref_metrics"]
    for k in ("loss", "grad_norm"):
        assert abs(m[k] - ref[k]) <= METRIC_TOL * abs(ref[k]), (k, m[k], ref[k])
    err, scale = res["errors"], res["scale"]
    assert err["mu"] <= MOMENT_TOL * scale["mu"], res
    assert err["nu"] <= MOMENT_TOL * scale["nu"], res
    assert err["params"] <= PARAM_TOL and err["ema"] <= PARAM_TOL, res


@pytest.mark.parametrize("check,layout", [
    ("dp", {"zero": True}), ("fsdp", {"fsdp": True}), ("sp_step", {"zero": True}),
    ("sp_fsdp_step", {"fsdp": True}), ("tp_step", {"tp": True}),
    ("tp_step_except_ff", {"tp": True}), ("fsdp_step_except_ff", {"fsdp": True})])
def test_train_step_at_2_ranks(world2, check, layout):
    """One optimizer step (accumulation 2, the global draws given, dropout
    off, EMA, remat dots_attn) at 2 ranks equals the single-process step:
    data parallel with ZeRO-2 moments, FSDP (the parameters DTensor
    shards), sequence parallel (ZeRO-2 over its one data rank, and FSDP
    over seq) and tensor parallel; TP and FSDP also under except_ff (whose
    keep mode spans whole blocks: TP's collectives and bias slices replay in
    step, FSDP2's gathers are kept out of it); every rank the same
    metrics."""
    for r in world2:
        _assert_step(r[check])
        assert r[check]["metrics"] == world2[0][check]["metrics"]
    res = world2[0][check]
    assert (res["zero_leaves"] > 0) == bool(layout.get("zero"))
    assert (res["fsdp_leaves"] > 0 and res["dtensor_params"] > 0) == bool(layout.get("fsdp"))
    assert (res["tp_leaves"] > 0) == bool(layout.get("tp"))


def test_tp_forward_at_2_ranks_and_the_naive_geglu_split(world2):
    """The TP UNet forward at 2 model ranks equals the single-process
    forward; with the naive [u | g] column split it misses."""
    for r in world2:
        assert r["tp_fwd"] <= FWD_TOL, r["tp_fwd"]
        assert r["fault_naive_geglu"] > FWD_TOL, r["fault_naive_geglu"]
    assert world2[0]["replicated_for_heads"] == []   # tiny: 2 and 4 heads


@pytest.mark.parametrize("path", ["explicit", "fallback"])
def test_sp_forward_at_4_ranks(world4, path):
    """The SP UNet forward at 4 seq ranks equals the single-process one: on
    the all-to-all path (B*T = 8, W = 16 and 8) and on the all-gather
    fallback (B*T = 3, W = 12 and 6: one rank holds no frame row)."""
    for r in world4:
        assert r["sp_fwd_" + path] <= FWD_TOL, r["sp_fwd_" + path]


@pytest.mark.parametrize("fault", ["fault_gn_unreduced", "fault_concat_reversed"])
def test_sp_planted_faults_miss(world4, fault):
    """The temporal GroupNorms' statistics left per rank, and the
    all-to-all's received blocks laid end to end in reverse, each move the
    forward beyond its bound."""
    for r in world4:
        assert r[fault] > 100 * FWD_TOL, (fault, r[fault])


def test_sp_sample_at_4_ranks(world4):
    """A 2-step `sample` (pixels and token ids, the VAE encode and decode
    frames-sharded) at 4 seq ranks equals the single-process sample."""
    for r in world4:
        assert r["sp_sample"] <= SAMPLE_TOL, r["sp_sample"]


def test_tp_forward_at_4_ranks_keeps_whole_heads(world4):
    """At 4 model ranks the tiny UNet's 2-head blocks (C = 32) stay whole,
    the 4-head ones are cut, and the forward equals the single-process
    one."""
    for r in world4:
        assert r["tp4_fwd"] <= FWD_TOL, r["tp4_fwd"]
    assert world4[0]["tp4_replicated"] == [
        n for n, blk in TP._blocks(TU.UNet3D(TP_.tiny().unet)) if blk.heads == 2]


@pytest.mark.parametrize("check,layout", [("tp_fsdp_step", ("tp", "fsdp")),
                                          ("dp_sp_step", ("zero",))])
def test_train_step_at_4_ranks(world4, check, layout):
    """data 2 x model 2 with FSDP (TP first, then each big leaf's TP-free
    dim over data), and data 2 x seq 2: one step equals the
    single-process step."""
    for r in world4:
        _assert_step(r[check])
    res = world4[0][check]
    assert (res["tp_leaves"] > 0) == ("tp" in layout)
    assert (res["fsdp_leaves"] > 0) == ("fsdp" in layout)
    assert (res["zero_leaves"] > 0) == ("zero" in layout)
