"""3D Gaussian scene representation: parameters and screen-space projection.

Port of `mudg_tpu/gs/gaussians.py`. Gaussians are a NamedTuple of tensors
with a fixed capacity N and an active mask, so shapes stay fixed across
densify/prune cycles. Projection follows EWA splatting (the 3DGS
convention): world covariance R S S^T R^T, the camera rotation, the local
affine Jacobian of the pinhole projection, and a 0.3 px low-pass. Written
plainly with batched 3x3 products; autograd keeps what it needs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Gaussians(NamedTuple):
    means: torch.Tensor       # (N, 3) world positions
    log_scales: torch.Tensor  # (N, 3)
    quats: torch.Tensor       # (N, 4) wxyz, unnormalized
    opacity: torch.Tensor     # (N,) logit
    colors: torch.Tensor      # (N, 3) rgb in [0, 1], the SH degree-0 (DC) part
    active: torch.Tensor      # (N,) bool, the fixed-capacity active mask
    sh: torch.Tensor | None = None     # (N, K, 3) rest SH coefficients,
                              # K = (deg+1)^2 - 1; None = view-independent
    sem: torch.Tensor | None = None    # (N, S) semantic class logits
    group: torch.Tensor | None = None  # (N,) int rigid-group id: 0 static
                              # background, i > 0 tracked object i, whose
                              # means/quats live in the object's canonical frame
    sh_rot: torch.Tensor | None = None  # (N, 3, 3) canonical->world rotation,
                              # set transiently by apply_group_transforms when
                              # sh is present; never stored or trained

    @property
    def n(self):
        return self.means.shape[0]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A camera matrix (numpy or tensor) as float32 on `like`'s device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def init_from_points(xyz, rgb, capacity: int | None = None,
                     init_scale: float | None = None, opacity: float = 0.1):
    """Seed gaussians from a colored point cloud (the LiDAR cloud), padded to
    `capacity` with inactive slots. xyz, rgb: (n, 3) float32 tensors."""
    n = xyz.shape[0]
    capacity = capacity or n
    assert capacity >= n
    dev = xyz.device
    if init_scale is None:
        # mean nearest-neighbour-ish spacing from the bounding-box volume
        bbox = xyz.max(0).values - xyz.min(0).values
        init_scale = float((torch.prod(bbox) / max(n, 1)) ** (1 / 3) + 1e-4)
    pad = capacity - n
    means = torch.cat([xyz, xyz.new_zeros((pad, 3))])
    colors = torch.cat([rgb, rgb.new_zeros((pad, 3))])
    return Gaussians(
        means=means,
        log_scales=torch.full((capacity, 3), math.log(init_scale), dtype=torch.float32,
                              device=dev),
        quats=torch.tensor([1.0, 0, 0, 0], device=dev).repeat(capacity, 1),
        opacity=torch.full((capacity,), math.log(opacity / (1 - opacity)), dtype=torch.float32,
                           device=dev),
        colors=colors,
        active=torch.arange(capacity, device=dev) < n,
    )


# Real spherical-harmonics constants (the INRIA gaussian-splatting ordering)
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_degree_from_k(k: int) -> int:
    deg = {3: 1, 8: 2, 15: 3}.get(k)
    assert deg is not None, f"unsupported SH coefficient count {k}"
    return deg


def sh_basis(dirs, deg: int):
    """Real SH basis (rest bands 1..deg) at unit directions, (N, 3) -> (N, K)."""
    assert 1 <= deg <= 3, deg
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    out = [-_C1 * y, _C1 * z, -_C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [_C2[0] * x * y, _C2[1] * y * z, _C2[2] * (2 * zz - xx - yy),
                _C2[3] * x * z, _C2[4] * (xx - yy)]
    if deg >= 3:
        out += [_C3[0] * y * (3 * xx - yy), _C3[1] * x * y * z,
                _C3[2] * y * (4 * zz - xx - yy),
                _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def view_colors(g: Gaussians, w2c):
    """Per-gaussian color for the camera at w2c: the DC color plus the SH
    rest bands at the camera->gaussian direction, clamped at 0. g.sh None
    returns g.colors unchanged."""
    if g.sh is None:
        return g.colors
    w2c = _f32(w2c, g.means)
    R, t = w2c[:3, :3], w2c[:3, 3]
    cam_pos = -R.T @ t
    d = g.means - cam_pos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-8)
    if g.sh_rot is not None:
        # the coefficients live in the object's canonical frame:
        # d_canonical = R_group^T d_world
        d = torch.einsum("nik,ni->nk", g.sh_rot, d)
    basis = sh_basis(d, sh_degree_from_k(g.sh.shape[1]))
    return torch.clamp(g.colors + torch.einsum("nk,nkc->nc", basis, g.sh), min=0.0)


def quat_mul(a, b):
    """Hamilton product of wxyz quaternions, broadcasting leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def rotmat_to_quat(R):
    """(..., 3, 3) -> (..., 4) wxyz, branchless: magnitudes from the diagonal,
    signs from the antisymmetric part (exact for w > 0)."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    w = torch.sqrt(torch.clamp(1 + r00 + r11 + r22, min=0.0)) / 2
    x = torch.sqrt(torch.clamp(1 + r00 - r11 - r22, min=0.0)) / 2
    y = torch.sqrt(torch.clamp(1 - r00 + r11 - r22, min=0.0)) / 2
    z = torch.sqrt(torch.clamp(1 - r00 - r11 + r22, min=0.0)) / 2
    x = torch.copysign(x, R[..., 2, 1] - R[..., 1, 2])
    y = torch.copysign(y, R[..., 0, 2] - R[..., 2, 0])
    z = torch.copysign(z, R[..., 1, 0] - R[..., 0, 1])
    return torch.stack([w, x, y, z], -1)


def apply_group_transforms(g: Gaussians, T, vis=None) -> Gaussians:
    """Move each rigid group's gaussians from its canonical frame to the
    frame's world pose: T (G, 4, 4) canonical->world per group (row 0 the
    static background), vis (G,) bool visibility. Differentiable wrt the
    canonical means and quats. g.group None returns g unchanged."""
    if g.group is None:
        return g
    T = _f32(T, g.means)
    R, t = T[:, :3, :3], T[:, :3, 3]
    grp = g.group.long()
    qT = rotmat_to_quat(R)
    means = torch.einsum("nij,nj->ni", R[grp], g.means) + t[grp]
    quats = quat_mul(qT[grp], g.quats)
    active = g.active
    if vis is not None:
        active = active & torch.as_tensor(vis, device=g.means.device).bool()[grp]
    out = g._replace(means=means, quats=quats, active=active)
    if g.sh is not None:
        out = out._replace(sh_rot=R[grp])
    return out


def with_sem(g: Gaussians, n_classes: int) -> Gaussians:
    """Attach zero semantic logits (a uniform class prior)."""
    return g._replace(sem=g.means.new_zeros((g.n, n_classes)))


def with_sh(g: Gaussians, deg: int) -> Gaussians:
    """Attach zero rest-band SH coefficients (the render is unchanged)."""
    assert 1 <= deg <= 3, deg
    k = (deg + 1) ** 2 - 1
    return g._replace(sh=g.means.new_zeros((g.n, k, 3)))


def quat_to_rotmat(q):
    """(N, 4) wxyz -> (N, 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


class Projected(NamedTuple):
    means2d: torch.Tensor    # (N, 2) pixel coords
    depths: torch.Tensor     # (N,)
    conics: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c) of
                             # a*dx^2 + 2*b*dx*dy + c*dy^2
    radii: torch.Tensor      # (N,) 3-sigma pixel radius
    opacities: torch.Tensor  # (N,) sigmoid
    visible: torch.Tensor    # (N,) bool
    extents: torch.Tensor    # (N, 2) per-axis half-extents of the ellipse where
                             # alpha can still reach ALPHA_MIN
    qmax: torch.Tensor       # (N,) that alpha-cutoff level-set value


def project_gaussians(g: Gaussians, K, w2c, *, width: int, height: int,
                      near: float = 0.05, far: float = 500.0,
                      eps2d: float = 0.3) -> Projected:
    """EWA projection of all gaussians into one camera (OpenCV convention)."""
    K, w2c = _f32(K, g.means), _f32(w2c, g.means)
    R, t = w2c[:3, :3], w2c[:3, 3]
    p_cam = g.means @ R.T + t
    z = p_cam[:, 2]
    # Gaussians at or behind the near plane are never visible; they are
    # projected at z = 1 so that their unused conics stay finite (at z ~ 0
    # the covariance overflows to inf, and autograd's 0 * inf would put NaN
    # in their otherwise zero gradients)
    zc = torch.where(z > near, z, torch.ones_like(z))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * p_cam[:, 0] / zc + cx
    v = fy * p_cam[:, 1] / zc + cy

    # cov2d = B B^T with B = J R_cam R_quat diag(S)
    M = (R @ quat_to_rotmat(g.quats)) * torch.exp(g.log_scales)[:, None, :]   # (N, 3, 3)
    zero = torch.zeros_like(zc)
    J = torch.stack([torch.stack([fx / zc, zero, -fx * p_cam[:, 0] / zc ** 2], -1),
                     torch.stack([zero, fy / zc, -fy * p_cam[:, 1] / zc ** 2], -1)], -2)
    B = J @ M                                                                   # (N, 2, 3)
    cov = B @ B.transpose(1, 2)
    c00 = cov[:, 0, 0] + eps2d   # low-pass: each splat covers ~ a pixel
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + eps2d

    det = torch.clamp(c00 * c11 - c01 ** 2, min=1e-12)
    conics = torch.stack([c11 / det, -c01 / det, c00 / det], -1)

    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid ** 2 - det, min=0.0))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))

    # tight per-axis AABB of the alpha cutoff: a splat contributes only where
    # op * exp(-q/2) >= 1/255, i.e. q <= qmax = 2 ln(255 op)
    opacities = torch.sigmoid(g.opacity)
    qmax = 2.0 * torch.log(torch.clamp(opacities, min=1e-12) * 255.0)
    qpos = torch.clamp(qmax, min=0.0)
    ext = torch.ceil(torch.sqrt(qpos[:, None] * torch.clamp(torch.stack([c00, c11], -1),
                                                            min=0.0)))
    visible = (g.active & (z > near) & (z < far)
               & (u + ext[:, 0] > 0) & (u - ext[:, 0] < width)
               & (v + ext[:, 1] > 0) & (v - ext[:, 1] < height)
               & (qmax > 0) & (ext[:, 0] > 0) & (ext[:, 1] > 0))
    return Projected(means2d=torch.stack([u, v], -1), depths=z, conics=conics, radii=radii,
                     opacities=opacities, visible=visible, extents=ext, qmax=qmax)


def rect_qmin(mux, muy, ca, cb, cc, lx, hx, ly, hy):
    """Exact minimum of q(d) = ca*dx^2 + 2*cb*dx*dy + cc*dy^2 over the rect
    [lx,hx]x[ly,hy] around the mean (mux, muy): 0 when the mean is inside,
    else the least of the four clamped 1D edge minima (the conic is PD)."""
    dx0, dx1 = lx - mux, hx - mux
    dy0, dy1 = ly - muy, hy - muy
    ca = torch.clamp(ca, min=1e-20)
    cc = torch.clamp(cc, min=1e-20)

    def q(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    qx0 = q(dx0, clip(-cb * dx0 / cc, dy0, dy1))
    qx1 = q(dx1, clip(-cb * dx1 / cc, dy0, dy1))
    qy0 = q(clip(-cb * dy0 / ca, dx0, dx1), dy0)
    qy1 = q(clip(-cb * dy1 / ca, dx0, dx1), dy1)
    qmin = torch.minimum(torch.minimum(qx0, qx1), torch.minimum(qy0, qy1))
    return torch.where(inside, torch.zeros_like(qmin), qmin)


# Safety margin on the cull threshold: the compositor computes q in another
# order, so borderline pairs get the benefit of the doubt
QMAX_CULL_EPS = 1e-3


def ellipse_row_xrange(ca, cb, cc, Q, dyl, dyu):
    """Exact x-interval (relative to the mean) of {q(d) <= Q} restricted to
    dy in [dyl, dyu] for the PD q = ca*dx^2 + 2*cb*dx*dy + cc*dy^2. Returns
    (lo, hi, nonempty)."""
    ca = torch.clamp(ca, min=1e-20)
    cc = torch.clamp(cc, min=1e-20)
    det = torch.clamp(ca * cc - cb * cb, min=1e-30)
    Qp = torch.clamp(Q, min=0.0)
    ey = torch.sqrt(ca * Qp / det)          # dy support half-width
    nonempty = (dyl <= ey) & (dyu >= -ey) & (Q > 0)
    lo_y = torch.minimum(torch.maximum(dyl, -ey), ey)
    hi_y = torch.minimum(torch.maximum(dyu, -ey), ey)

    def mh(dy, sign):
        h = torch.sqrt(torch.clamp(ca * Qp - det * dy * dy, min=0.0)) / ca
        return -(cb / ca) * dy + sign * h

    ex = torch.sqrt(cc * Qp / det)          # global dx half-extent
    dy_star = -cb * torch.sqrt(Qp / (cc * det))
    hi = torch.where((dy_star >= lo_y) & (dy_star <= hi_y), ex,
                     torch.maximum(mh(lo_y, 1.0), mh(hi_y, 1.0)))
    lo = torch.where((-dy_star >= lo_y) & (-dy_star <= hi_y), -ex,
                     torch.minimum(mh(lo_y, -1.0), mh(hi_y, -1.0)))
    return lo, hi, nonempty
