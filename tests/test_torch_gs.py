"""The port's 3DGS scene and rasterizers against the JAX package, f32 on the
CPU, the same seeded numpy gaussians fed to both.

Tolerances:
  * projection, SH colors, group transforms, the row x-range and rect
    minimum: max|diff| <= 1e-5 * max|ref| (f32 rounding of two op orders);
    the integer decisions (visibility, extents, radii, pair counts) equal;
  * tile rasterizer (kernel 13's plain version) against `rasterize_pallas`
    in Pallas interpret mode with MUDG_GS_SORT=lex, at
    tests/test_tile_raster.py's 96x64 scenes: color and alpha atol 2e-5,
    depth 2e-4, features 2e-5 (test_tile_raster.py:41-44, :201); every
    gradient within 2e-3 * max|ref| + 1e-8 (:94-96);
  * the capped path (`backend="xla"`) against JAX `rasterize`: the same;
  * the plain backward against autograd through the plain forward (both
    float64 inside): 1e-6 * max|ref|; planted faults must miss the chip
    check's bounds (forward 1e-4 * max|ref|, backward 2e-3 * max|ref|).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.gs import gaussians as JG
from mudg_tpu.gs import rasterize as JR
from mudg_tpu.gs import tile_raster as JTR
from mudg_tpu_torch.gs import gaussians as TG
from mudg_tpu_torch.gs import rasterize as TR
from mudg_tpu_torch.gs import tile_raster as TT
from mudg_tpu_torch.kernels import tile_raster as KT
from test_torch_util import assert_close, t

WIDTH, HEIGHT = 96, 64
K = np.array([[60.0, 0, 48.0], [0, 60.0, 32.0], [0, 0, 1]], np.float32)
W2C = np.eye(4, dtype=np.float32)
FIELDS = ("means", "log_scales", "quats", "opacity", "colors")
REL = 1e-5
GRAD_REL, GRAD_ATOL = 2e-3, 1e-8


@pytest.fixture(autouse=True)
def lex_sort(monkeypatch):
    """The JAX tile path's lossless (tile, depth) sort, the port's order."""
    monkeypatch.setenv("MUDG_GS_SORT", "lex")


def scene(n=300, seed=0, spread=4.0, opacity=None):
    """tests/test_tile_raster.py's scene as numpy fields."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, spread, (n, 3)).astype(np.float32) + np.float32([0, 0, 10.0])
    xyz[:, 2] = np.clip(xyz[:, 2], 2.0, 25.0)
    rgb = rng.random((n, 3)).astype(np.float32)
    g = JG.init_from_points(jnp.asarray(xyz), jnp.asarray(rgb), opacity=0.35)
    f = {k: np.asarray(getattr(g, k)) for k in g._fields if getattr(g, k) is not None}
    if opacity is not None:
        f["opacity"] = np.full(n, opacity, np.float32)
    return f


def random_fields(n=200, seed=1, sh_k=15, groups=0):
    """Gaussians with random rotations, anisotropic scales, SH and groups."""
    rng = np.random.default_rng(seed)
    f = {"means": (rng.normal(0, 3, (n, 3)) + [0, 0, 9]).astype(np.float32),
         "log_scales": rng.normal(-1.2, 0.5, (n, 3)).astype(np.float32),
         "quats": rng.normal(0, 1, (n, 4)).astype(np.float32),
         "opacity": rng.normal(-1, 2, n).astype(np.float32),
         "colors": rng.random((n, 3)).astype(np.float32),
         "active": rng.random(n) < 0.9}
    if sh_k:
        f["sh"] = (rng.normal(0, 0.2, (n, sh_k, 3))).astype(np.float32)
    if groups:
        f["group"] = rng.integers(0, groups, n).astype(np.int32)
    return f


def jax_g(f):
    return JG.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()})


def port_g(f):
    return TG.Gaussians(**{k: t(v) for k, v in f.items()})


def test_projection_matches_jax():
    f = random_fields()
    ref = JG.project_gaussians(jax_g(f), jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                               height=HEIGHT)
    ours = TG.project_gaussians(port_g(f), t(K), t(W2C), width=WIDTH, height=HEIGHT)
    vis = np.asarray(ref.visible)
    assert vis.sum() > 50
    np.testing.assert_array_equal(ours.visible.numpy(), vis)
    for name in ("means2d", "depths", "conics", "opacities", "qmax"):
        a, b = getattr(ours, name).numpy()[vis], np.asarray(getattr(ref, name))[vis]
        assert_close(a, b, REL, name=name)
    np.testing.assert_array_equal(ours.extents.numpy()[vis], np.asarray(ref.extents)[vis])
    np.testing.assert_array_equal(ours.radii.numpy()[vis], np.asarray(ref.radii)[vis])


def test_sh_colors_and_group_transforms_match_jax():
    f = random_fields(groups=3)
    rng = np.random.default_rng(5)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i in (1, 2):   # rotations about y by 0.3 and -0.7 rad, with shifts
        a = (0.3, -0.7)[i - 1]
        T[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        T[i, :3, 3] = rng.normal(0, 1, 3)
    vis = np.array([True, True, False])
    w2c = W2C.copy()
    w2c[:3, 3] = [0.3, -0.2, 0.5]
    gj = JG.apply_group_transforms(jax_g(f), jnp.asarray(T), jnp.asarray(vis))
    gt = TG.apply_group_transforms(port_g(f), t(T), t(vis))
    for name in ("means", "quats", "sh_rot"):
        assert_close(getattr(gt, name), np.asarray(getattr(gj, name)), REL, name=name)
    np.testing.assert_array_equal(gt.active.numpy(), np.asarray(gj.active))
    assert_close(TG.view_colors(gt, t(w2c)), np.asarray(JG.view_colors(gj, jnp.asarray(w2c))),
                 REL, name="view_colors")
    for k in (3, 8):   # SH degrees 1 and 2
        fk = random_fields(sh_k=k, seed=k)
        assert_close(TG.view_colors(port_g(fk), t(w2c)),
                     np.asarray(JG.view_colors(jax_g(fk), jnp.asarray(w2c))), REL,
                     name=f"view_colors k={k}")


def test_row_xrange_and_rect_qmin_match_jax():
    rng = np.random.default_rng(2)
    n = 500
    a, c = rng.uniform(0.01, 1, n), rng.uniform(0.01, 1, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    q = rng.uniform(-1, 20, n)
    lo_y = rng.uniform(-20, 20, n)
    args = [x.astype(np.float32) for x in (a, b, c, q, lo_y, lo_y + 15)]
    ref = JG.ellipse_row_xrange(*map(jnp.asarray, args))
    ours = TG.ellipse_row_xrange(*map(t, args))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    keep = np.asarray(ref[2])
    for x, y, name in ((ours[0], ref[0], "lo"), (ours[1], ref[1], "hi")):
        assert_close(x.numpy()[keep], np.asarray(y)[keep], REL, name=name)
    mu = rng.uniform(-30, 30, (2, n)).astype(np.float32)
    rect = [np.float32(v) for v in (-7.5, 7.5, -7.5, 7.5)]
    ref = JG.rect_qmin(*map(jnp.asarray, (*mu, *args[:3])), *rect)
    ours = TG.rect_qmin(*map(t, (*mu, *args[:3])), *map(torch.tensor, rect))
    assert_close(ours, np.asarray(ref), REL, name="rect_qmin")


@pytest.mark.parametrize("seed", [0, 4])
def test_count_pairs_matches_jax(seed):
    f = scene(n=250, seed=seed)
    pj = JG.project_gaussians(jax_g(f), jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                              height=HEIGHT)
    rows, pairs = JTR.count_pairs(pj, width=WIDTH, height=HEIGHT, max_rows=1 << 14)
    pt = TG.project_gaussians(port_g(f), t(K), t(W2C), width=WIDTH, height=HEIGHT)
    assert TT.count_pairs(pt, width=WIDTH, height=HEIGHT) == (int(rows), int(pairs))
    feats, bounds, nd = TT.build_pairs(pt, pt.opacities.new_zeros(250, 3), width=WIDTH,
                                       height=HEIGHT)
    assert nd == 0 and feats.shape == (int(pairs), 10) and int(bounds[-1]) == int(pairs)
    assert bool((bounds[1:] >= bounds[:-1]).all())


def _scene_for(kind):
    if kind == "dense":   # saturating tiles (opacity logit 3.0, sigmoid ~0.95)
        return scene(n=600, spread=0.8, opacity=3.0), 1 << 15
    return scene(), 8192


@pytest.mark.parametrize("kind", ["mixed", "dense"])
def test_tile_forward_matches_jax(kind):
    f, budget = _scene_for(kind)
    ref = JTR.rasterize_pallas(jax_g(f), jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                               height=HEIGHT, max_pairs=budget)
    ours = TT.rasterize_tiles(port_g(f), t(K), t(W2C), width=WIDTH, height=HEIGHT)
    assert int(ref.n_dropped) == 0 and ours.n_dropped == 0
    for name, atol in (("color", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        assert_close(getattr(ours, name), np.asarray(getattr(ref, name)), 0.0, atol, name)
    assert float(ours.alpha.max()) > 0.2


def _grads(loss_fn_j, loss_fn_t, f, names):
    gj = jax.grad(loss_fn_j, argnums=tuple(range(len(names))))(
        *[jnp.asarray(f[k]) for k in names])
    xs = [t(f[k]).requires_grad_() for k in names]
    gt = torch.autograd.grad(loss_fn_t(*xs), xs)
    for name, a, b in zip(names, gt, gj):
        assert_close(a, np.asarray(b), GRAD_REL, GRAD_ATOL, f"d{name}")


def _color_loss(out, lib):
    return lib.mean((out.color - 0.25) ** 2) + 0.1 * lib.mean(out.alpha)


@pytest.mark.parametrize("backend", ["tile", "xla"])
def test_gradients_match_jax(backend):
    f = scene(n=150)

    def lj(*xs):
        g = jax_g(f)._replace(**dict(zip(FIELDS, xs)))
        if backend == "tile":
            out = JTR.rasterize_pallas(g, jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                                       height=HEIGHT, max_pairs=8192)
        else:
            out = JR.rasterize(g, jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                               height=HEIGHT, max_per_tile=512, tiles_per_gaussian=36)
        return _color_loss(out, jnp)

    def lt(*xs):
        g = port_g(f)._replace(**dict(zip(FIELDS, xs)))
        if backend == "tile":
            out = TT.rasterize_tiles(g, t(K), t(W2C), width=WIDTH, height=HEIGHT)
        else:
            out = TR.rasterize(g, t(K), t(W2C), width=WIDTH, height=HEIGHT,
                               max_per_tile=512, tiles_per_gaussian=36)
        return _color_loss(out, torch)

    _grads(lj, lt, f, FIELDS)


def test_xla_backend_forward_matches_jax():
    f = scene()
    ref = JR.rasterize(jax_g(f), jnp.asarray(K), jnp.asarray(W2C), width=WIDTH, height=HEIGHT,
                       max_per_tile=512, tiles_per_gaussian=36)
    ours = TR.rasterize(port_g(f), t(K), t(W2C), width=WIDTH, height=HEIGHT,
                        max_per_tile=512, tiles_per_gaussian=36)
    assert ours.n_dropped == int(ref.n_dropped) == 0
    for name, atol in (("color", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        assert_close(getattr(ours, name), np.asarray(getattr(ref, name)), 0.0, atol, name)
    capped = TR.rasterize(port_g(f), t(K), t(W2C), width=WIDTH, height=HEIGHT,
                          max_per_tile=64, tiles_per_gaussian=4)
    ref = JR.rasterize(jax_g(f), jnp.asarray(K), jnp.asarray(W2C), width=WIDTH, height=HEIGHT,
                       max_per_tile=64, tiles_per_gaussian=4)
    assert capped.n_dropped == int(ref.n_dropped) > 0
    assert_close(capped.color, np.asarray(ref.color), 0.0, 2e-5, "capped color")


def test_semantic_features_and_gradients_match_jax():
    """19 class channels (npay 23) composite as on the JAX tile path, and the
    gradients of a semantic cross-entropy loss agree."""
    f = scene(n=120)
    rng = np.random.default_rng(11)
    f["logits"] = rng.normal(0, 1, (120, 19)).astype(np.float32)
    tgt = rng.integers(0, 19, (HEIGHT, WIDTH))

    def loss(out, lib, onehot):
        def floor(x, v):
            return jnp.maximum(x, v) if lib is jnp else x.clamp(min=v)

        p = out.features / floor(out.alpha[..., None], 1e-6)
        ce = -lib.log(floor(lib.sum(p * onehot, -1), 1e-8))
        mask = (out.alpha > 0.5) * 1.0
        return lib.sum(ce * mask) / floor(lib.sum(mask), 1.0) + lib.mean(
            (out.color - 0.25) ** 2)

    def lj(means, opacity, logits):
        g = jax_g({k: v for k, v in f.items() if k != "logits"})._replace(means=means,
                                                                         opacity=opacity)
        out = JTR.rasterize_pallas(g, jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                                   height=HEIGHT, max_pairs=8192,
                                   features=jax.nn.softmax(logits, -1))
        return loss(out, jnp, jax.nn.one_hot(tgt, 19))

    def lt(means, opacity, logits):
        g = port_g({k: v for k, v in f.items() if k != "logits"})._replace(means=means,
                                                                          opacity=opacity)
        out = TT.rasterize_tiles(g, t(K), t(W2C), width=WIDTH, height=HEIGHT,
                                 features=torch.softmax(logits, -1))
        assert out.features.shape == (HEIGHT, WIDTH, 19)
        return loss(out, torch, torch.nn.functional.one_hot(t(tgt), 19).float())

    base = {k: v for k, v in f.items() if k != "logits"}
    feat = jax.nn.softmax(jnp.asarray(f["logits"]), -1)
    ref = JTR.rasterize_pallas(jax_g(base), jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                               height=HEIGHT, max_pairs=8192, features=feat)
    ours = TT.rasterize_tiles(port_g(base), t(K), t(W2C), width=WIDTH, height=HEIGHT,
                              features=torch.softmax(t(f["logits"]), -1))
    assert_close(ours.features, np.asarray(ref.features), 0.0, 2e-5, "features")
    assert_close(ours.color, np.asarray(ref.color), 0.0, 2e-5, "color")
    _grads(lj, lt, f, ("means", "opacity", "logits"))


def test_explicit_budget_drops_as_jax():
    f = scene(n=400)
    ref = JTR.rasterize_pallas(jax_g(f), jnp.asarray(K), jnp.asarray(W2C), width=WIDTH,
                               height=HEIGHT, max_pairs=256)
    ours = TT.rasterize_tiles(port_g(f), t(K), t(W2C), width=WIDTH, height=HEIGHT,
                              max_pairs=256)
    assert ours.n_dropped == int(ref.n_dropped) > 0


def _pairs(kind, npay=4):
    f, _ = _scene_for(kind)
    g = port_g(f)
    proj = TG.project_gaussians(g, t(K), t(W2C), width=WIDTH, height=HEIGHT)
    extras = None
    if npay > 4:
        extras = torch.softmax(torch.randn(g.n, npay - 4, generator=torch.Generator()
                                           .manual_seed(3)), -1)
    feats, bounds, _ = TT.build_pairs(proj, g.colors, width=WIDTH, height=HEIGHT,
                                      extras=extras)
    return feats.detach().contiguous(), bounds


@pytest.mark.parametrize("kind,npay", [("mixed", 4), ("dense", 4), ("mixed", 23)])
def test_plain_backward_matches_autograd_and_sees_faults(kind, npay):
    """The explicit two-sweep backward equals autograd through the plain
    forward; the planted faults of chip_smoke.py phase 9 (pairs composited
    back to front; the occlusion term dropped) miss its bounds."""
    feats, bounds = _pairs(kind, npay)
    tw = WIDTH // 16
    x = feats.clone().requires_grad_()
    out, last = KT.plain_tile_composite(x, bounds, tw, npay)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (ref,) = torch.autograd.grad((out * gout).sum(), x)
    got = KT.plain_tile_composite_bwd(feats, bounds, gout, tw, npay)
    assert_close(got, ref, 1e-6, name="bwd")
    fault = KT.plain_tile_composite_bwd(feats, bounds, gout, tw, npay, drop_occlusion=True)
    assert (fault - ref).abs().max() > GRAD_REL * ref.abs().max()
    rev, _ = KT.plain_tile_composite(feats, bounds, tw, npay, reverse=True)
    assert (rev - out.detach()).abs().max() > 1e-4 * out.abs().max()
    # `last` marks the last contributing pair: past it no pair changes the pixel
    counts = (bounds[1:] - bounds[:-1]).long()
    assert bool((last.long() <= counts[:, None]).all()) and int(last.max()) > 0
    if kind == "dense":
        assert float(out.detach()[:, npay].min()) <= 1e-4   # saturated pixels exist


def test_gather_backward_is_a_segment_sum():
    """The pair-table gather's backward (a segment sum over pairs grouped by
    gaussian) equals index_add_ and is bit-identical across runs."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn(50, 10, generator=g).requires_grad_()
    idx = torch.randint(0, 40, (700,), generator=g)
    grad = torch.randn(700, 10, generator=g)
    (a,) = torch.autograd.grad(TT._GatherRows.apply(table, idx), table, grad)
    ref = torch.zeros(50, 10).index_add_(0, idx, grad)
    assert_close(a, ref, 1e-6, name="segment sum")
    assert a[40:].abs().max() == 0
    (b,) = torch.autograd.grad(TT._GatherRows.apply(table, idx), table, grad)
    assert torch.equal(a, b)
