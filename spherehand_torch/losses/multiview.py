"""Multi-view self-supervision: the mutual-projection and consistency losses.

Counterpart of ``spherehand_tpu/losses/multiview.py`` (reference
mesh/multiview_utility.py:9-237). Camera-pose quirk kept: translations are
read from column [:3, 3], which the NYU generator leaves ~0 (it writes its
translations into row [3, :3]), so cross-view transforms are effectively
rotation-only.

``mutual_projection_loss`` has the JAX package's two branches
(multiview.py:111-157), chosen as there by where the tensors live
(``render.sphere._fuse_spheres``):

- fused, on CUDA: one call of
  :func:`spherehand_torch.render.sphere_cuda.sphere_min_depth_and_d2m` gives
  both fields of the projected sphere set against the observed maps, and its
  backward the summed centre gradient;
- unfused, on the CPU: :func:`mutual_projection` renders the depth field and
  :func:`spherehand_torch.render.sphere.data_to_model_distance` measures the
  distance field, on the broadcast (B, V, V) pairs and again per view on the
  diagonal, with the plain broadcast fields the goldens pin.

``fused=`` overrides the choice, so that the two can be held against each
other on one device; on CUDA both run kernels.

On the CPU the view transforms (:func:`mutual_transforms`,
:func:`apply_rigid`) round as XLA's do, so the port's projected joints are
op-by-op JAX's bits; the card keeps the einsums.
"""
from __future__ import annotations

import torch

from spherehand_torch.ops.reduce import bmean, bmean_keep
from spherehand_torch.ops.softargmax import heatmap_variance
from spherehand_torch.render.sphere import _fuse_spheres, data_to_model_distance, render_spheres
from spherehand_torch.render.sphere_cuda import sphere_min_depth, sphere_min_depth_and_d2m


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add does.

    The product is exact in float64; the sum is taken there rounded to odd
    (its last bit set where the float64 sum was inexact, from the exact
    error of TwoSum), and that rounds to float32 as the exact sum would:
    float64 carries more than 24 + 2 bits."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (err > 0) == (s > 0)  # the exact sum's magnitude lies above |s|
    return torch.where(odd, (bits + torch.where(away, 1, -1)).view(torch.float64), s).float()


def _exact_order(*tensors: torch.Tensor) -> bool:
    """JAX's CPU bits are reproduced for float32 on the CPU; the card keeps
    the einsum (its joints come from TF32 convolutions anyway)."""
    return all(t.device.type == "cpu" and t.dtype == torch.float32 for t in tensors)


def mutual_transforms(poses: torch.Tensor, inv_poses: torch.Tensor) -> torch.Tensor:
    """All-pairs view transforms: out[b, i, j] = inv_poses[b, j] @ poses[b, i].
    poses (B, V, 4, 4) -> (B, V, V, 4, 4).

    On the CPU in float32 each entry is XLA's: the four products rounded,
    then summed pairwise, (p0 + p1) + (p2 + p3), which is what JAX's
    ``einsum`` gives there, jitted or op by op, at the losses' three views
    (XLA picks its order by shape: one view gets a chain of fused
    multiply-adds instead)."""
    if not _exact_order(poses, inv_poses):
        return torch.einsum("bjmn,binl->bijml", inv_poses, poses)
    a = inv_poses[:, None, :, :, :, None]  # (B, 1, Vj, m, n, 1)
    b = poses[:, :, None, None, :, :]       # (B, Vi, 1, 1, n, l)
    p = [a[..., n, :] * b[..., n, :] for n in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def apply_rigid(mats: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid transforms applied to (..., N, 3) points: rotation
    [:3, :3], translation from column [:3, 3].

    On the CPU in float32 each coordinate is XLA's at the losses' shapes
    (three views): a chain of fused multiply-adds over n, fma(x2, r2,
    fma(x1, r1, x0 r0)), then + t. The gradient is the einsum's (the
    chain's bit arithmetic has none)."""
    rotated = torch.einsum("...mn,...jn->...jm", mats[..., :3, :3], points)
    if _exact_order(mats, points):
        with torch.no_grad():
            r = mats[..., None, :3, :3]  # (..., 1, m, n)
            x = points[..., None, :]     # (..., N, 1, n)
            shape = torch.broadcast_shapes(r.shape[:-1], x.shape[:-1])
            exact = x[..., 0] * r[..., 0]
            for n in (1, 2):
                exact = _fma(x[..., n].expand(shape), r[..., n].expand(shape), exact)
        # the chain's value (x - +0 keeps a -0) with the einsum's gradient
        rotated = exact - (rotated.detach() - rotated)
    return rotated + mats[..., None, :3, 3]


def mutual_projection(poses: torch.Tensor, inv_poses: torch.Tensor, joints: torch.Tensor,
                      radii: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Render every view's spheres into every other view.

    joints (B, V, J, 3) mm per view -> (depth maps (B, V, V, S, S),
    projected joints (B, V, V, J, 3)), [b, i, j] holding view i's joints in
    view j's camera (multiview_utility.py:55-77). The view transforms carry
    no gradient. On CUDA the depth maps are the ``sphere_min_depth``
    kernel's, on the CPU the min over the plain per-sphere maps."""
    mats = mutual_transforms(poses, inv_poses).detach()
    projected = apply_rigid(mats, joints[:, :, None])  # (B, V, V, J, 3)
    if _fuse_spheres(projected.device):
        b, vi, vj, num_j, _ = projected.shape
        depth_maps = sphere_min_depth(
            projected.reshape(b * vi * vj, num_j, 3), radii, size).reshape(b, vi, vj, size, size)
    else:
        depth_maps = render_spheres(projected, radii, size).amin(dim=-3)
    return depth_maps, projected


def mutual_projection_loss(
    poses: torch.Tensor,
    inv_poses: torch.Tensor,
    joints: torch.Tensor,
    real_dms: torch.Tensor,
    radii: torch.Tensor,
    is_mv: bool | torch.Tensor = True,
    weights: torch.Tensor | None = None,
    fused: bool | None = None,
    total=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Model <-> data alignment across views (multiview_utility.py:90-130).

    joints (B, V, J, 3) mm per view; real_dms (B, V, S, S) observed depth in
    mm (background 100). The mv branch covers all V x V pairs (x9), the sv
    branch the own-view diagonal (x3); each is m2d + 500 d2m. Both are
    computed and ``is_mv`` selects. ``fused`` picks the fused or unfused
    form (default: fused on CUDA, unfused on the CPU). ``total``: the
    global sample count on one rank of several (``ops.reduce``). Returns
    (loss, projected depth maps (B, V, V, S, S)).
    """
    size = real_dms.shape[-1]
    num_views = real_dms.shape[1]
    diag = torch.arange(num_views, device=real_dms.device)
    if fused is None:
        fused = _fuse_spheres(real_dms.device)
    if fused:
        mats = mutual_transforms(poses, inv_poses).detach()
        projected = apply_rigid(mats, joints[:, :, None])  # (B, V, V, J, 3)
        b, vi, vj, num_j, _ = projected.shape
        depth, dist = sphere_min_depth_and_d2m(
            projected.reshape(b * vi * vj, num_j, 3),
            real_dms.reshape(b * num_views, size, size),
            radii, size, views=num_views,
        )
        projected_dms = depth.reshape(b, vi, vj, size, size)
        dist_field = torch.clamp(dist.reshape(b, vi, vj, size, size), 0.0, 50.0)
        d2m_mv = bmean(dist_field, weights, total) * 9.0
        # the diagonal [b, v, v] of the same field is the own-view d2m term
        d2m_sv = bmean_keep(dist_field[:, diag, diag], weights, (2, 3), total).sum() * 3.0
    else:
        projected_dms, projected = mutual_projection(poses, inv_poses, joints, radii, size)
        # target[b, i, j] = real_dms[b, j]
        target = real_dms[:, None].expand_as(projected_dms)
        d2m_mv = data_to_model_distance(target, projected, radii, weights, total) * 9.0
        joints_diag = projected[:, diag, diag]  # (B, V, J, 3)
        d2m_sv = sum(data_to_model_distance(real_dms[:, v], joints_diag[:, v], radii, weights,
                                            total)
                     for v in range(num_views)) * 3.0

    m2d_mv = bmean((projected_dms - real_dms[:, None]) ** 2, weights, total) * 9.0
    proj_diag = projected_dms[:, diag, diag]  # (B, V, S, S)
    m2d_sv = bmean_keep((proj_diag - real_dms) ** 2, weights, (2, 3), total).sum() * 3.0

    loss_mv = m2d_mv + 500.0 * d2m_mv
    loss_sv = m2d_sv + 500.0 * d2m_sv
    loss = torch.where(torch.as_tensor(is_mv, device=loss_mv.device), loss_mv, loss_sv)
    return loss, projected_dms


def multiview_consistency_loss(
    poses: torch.Tensor, joints: torch.Tensor, weights: torch.Tensor | None = None,
    total=None,
) -> torch.Tensor:
    """MSE of the per-view canonical joints (B, V, J, 3) against their
    per-coordinate median over views (the lower middle value for even V)."""
    canonical = apply_rigid(poses, joints)
    num_views = canonical.shape[1]
    med = torch.sort(canonical, dim=1).values[:, (num_views - 1) // 2]
    return bmean((med[:, None] - canonical) ** 2, weights, total)


def _pick_views(canonical: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """canonical (B, V, J, 3), view (B, J) -> the chosen view's joints (B, 1, J, 3)."""
    index = view[:, None, :, None].expand(-1, 1, -1, canonical.shape[-1])
    return torch.gather(canonical, 1, index)


def weighted_multiview_consistency_loss(
    poses: torch.Tensor, joints: torch.Tensor, hm_weight: torch.Tensor
) -> torch.Tensor:
    """Sum of squared deviations of every view's canonical joints from those
    of the view with the highest confidence ``hm_weight`` (B, V, J)
    (WeightedMultiviewConsistencyLoss, multiview_utility.py:170-201; the
    reference never constructs it)."""
    canonical = apply_rigid(poses, joints)
    return ((_pick_views(canonical, hm_weight.argmax(dim=1)) - canonical) ** 2).sum()


def fuse_mv_pose(joints: torch.Tensor, poses: torch.Tensor, inv_poses: torch.Tensor,
                 uv_hms: torch.Tensor) -> torch.Tensor:
    """Per joint, the canonical estimate of the view whose heatmap (B, V, J,
    H, W) has the lowest spatial variance (weight exp(-10 var)), mapped back
    into every view: (B, V, J, 3) (FuseMvPose, multiview_utility.py:208-237;
    the reference never calls it)."""
    canonical = apply_rigid(poses, joints)
    weight = torch.exp(-10.0 * heatmap_variance(uv_hms)).detach()
    return apply_rigid(inv_poses, _pick_views(canonical, weight.argmax(dim=1)))
