"""NYU multi-view dataset: offline preprocessing and the memmap batch loader.

Counterpart of ``spherehand_tpu/data/nyu.py`` (reference
``dataset/nyu_generator.py``, ``dataset/utils.py``, ``dataset/nyu_dataset.py``),
kept as the port's own numpy copy so that nothing here imports the JAX
package. The code is the same, line for line, apart from the native
binding it reaches (:mod:`spherehand_torch.data.native`) and
:func:`write_shard`, the shard writer as a function of its own.

The on-disk shard format is byte-compatible with the JAX package and the
reference (``mv_data_N_shape.pkl`` + ``_dms.bat`` float32 memmap +
``_joint_poses.npy`` + ``_camera_poses.npy``), so a dataset preprocessed by
any of them serves all three.

:class:`NyuLoader` serves whole batches as stacked numpy arrays (one memmap
gather a step); its index plan derives from ``(seed, epoch)`` alone, so a
resumed run replays the order of the epochs it re-enters, and the engine's
card-resident path (``device_data``) gathers the same rows on the device.

Camera-pose quirk (kept for loss parity): Kabsch translations are stored in
ROW [3, :3] (utils.py:142-145) while the training losses read COLUMN
[:3, 3] (multiview_utility.py:71,153): effectively rotation-only
cross-view transforms, which is sound because every view is root-centered.
"""
from __future__ import annotations

import os
import pickle
from typing import Iterator, NamedTuple

import numpy as np


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics; NYU Kinect defaults (reference dataset/utils.py:7-11)."""

    fx: float = 588.235
    fy: float = 587.084
    cx: float = 320.0
    cy: float = 240.0


def perspective_project(xyz: np.ndarray, cam: CameraIntrinsics) -> np.ndarray:
    """(..., 3) camera-space points -> (..., 3) pixel coords (u, v, z)."""
    u = xyz[..., 0] * cam.fx / xyz[..., 2] + cam.cx
    v = xyz[..., 1] * cam.fy / xyz[..., 2] + cam.cy
    return np.stack([u, v, xyz[..., 2]], axis=-1)


def perspective_backproject(uvd: np.ndarray, cam: CameraIntrinsics) -> np.ndarray:
    x = (uvd[..., 0] - cam.cx) * uvd[..., 2] / cam.fx
    y = (uvd[..., 1] - cam.cy) * uvd[..., 2] / cam.fy
    return np.stack([x, y, uvd[..., 2]], axis=-1)


def orthographic_project_np(xyz: np.ndarray, cam: CameraIntrinsics) -> np.ndarray:
    u = xyz[..., 0] * cam.fx + cam.cx
    v = xyz[..., 1] * cam.fy + cam.cy
    return np.stack([u, v, xyz[..., 2]], axis=-1)


def crop_depth_map(
    dm: np.ndarray,
    center_xyz: np.ndarray,
    cam: CameraIntrinsics,
    cube_mm: float = 300.0,
    out_size: int = 64,
    background: float = 100.0,
) -> np.ndarray:
    """Crop a metric cube around ``center_xyz`` into an orthographic patch.

    Backprojects every in-range ROI pixel to 3D, recenters on the cube center,
    orthographically projects into the out_size patch (last-write-wins
    scatter), background = 100 (reference dataset/utils.py:70-124).
    """
    height, width = dm.shape
    half = cube_mm / 2.0
    z0, z1 = center_xyz[2] - half, center_xyz[2] + half
    top_left = perspective_project(center_xyz + np.asarray([-half, -half, -half]), cam)
    bottom_right = perspective_project(center_xyz + np.asarray([half, half, -half]), cam)
    u0, u1 = int(max(top_left[0], 0)), int(min(bottom_right[0], width))
    v0, v1 = int(max(top_left[1], 0)), int(min(bottom_right[1], height))

    out = np.full((out_size, out_size), background, np.float32)
    roi = dm[v0:v1, u0:u1]
    mask = (roi >= z0) & (roi < z1)
    if not mask.any():
        return out
    vv, uu = np.nonzero(mask)
    uvd = np.stack(
        [(uu + u0).astype(np.float32), (vv + v0).astype(np.float32), roi[mask]],
        axis=-1,
    )
    render_cam = CameraIntrinsics(
        fx=out_size / cube_mm, fy=out_size / cube_mm,
        cx=out_size / 2.0, cy=out_size / 2.0,
    )
    ortho = orthographic_project_np(
        perspective_backproject(uvd, cam) - center_xyz[None, :], render_cam
    )
    ui = ortho[:, 0].astype(np.int32)
    vi = ortho[:, 1].astype(np.int32)
    ok = (ui >= 0) & (ui < out_size) & (vi >= 0) & (vi < out_size)
    out[vi[ok], ui[ok]] = ortho[ok, 2]
    return out


def kabsch_transform(points_a: np.ndarray, points_b: np.ndarray) -> np.ndarray:
    """Best-fit rigid transform a -> b; translation stored in ROW [3, :3]
    (reference dataset/utils.py:127-145 — see module docstring)."""
    ca, cb = points_a.mean(0), points_b.mean(0)
    h = (points_a - ca).T @ (points_b - cb)
    u, _, vt = np.linalg.svd(h)
    rot = vt.T @ u.T
    if np.linalg.det(rot) < 0:
        vt[2] *= -1
        rot = vt.T @ u.T
    t = -rot @ ca + cb
    out = np.eye(4)
    out[:3, :3] = rot
    out[3, :3] = t
    return out


def decode_nyu_depth_png(path: str) -> np.ndarray:
    """NYU RGB-coded depth: depth = G << 8 | B (nyu_generator.py:48-53)."""
    from PIL import Image

    img = np.asarray(Image.open(path), np.int32)
    return ((img[..., 1] << 8) | img[..., 2]).astype(np.float32)


def _prepare_sample(args) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    src_dir, names, joints, cube, out_size = args
    cam = CameraIntrinsics()
    dms, poses = [], []
    for view, name in enumerate(names):
        dm = decode_nyu_depth_png(os.path.join(src_dir, name))
        ann = joints[view]
        dms.append(crop_depth_map(dm, ann[32], cam, cube, out_size))
        poses.append(ann - ann[32][None])
    camera_poses = [np.eye(4)]
    for view in range(1, len(names)):
        camera_poses.append(kabsch_transform(poses[view], poses[0]))
    return (
        np.stack(dms).astype(np.float32),
        np.stack(poses).astype(np.float32),
        np.stack(camera_poses).astype(np.float32),
    )


class NyuDatasetGenerator:
    """Offline NYU preprocessing, shard-compatible with the reference.

    nyu_generator.py:15-141, parallelized over samples.
    """

    def __init__(self, dataset_dir: str, subset: str, out_size: int = 64,
                 cube_mm: float = 300.0, num_views: int = 3):
        import scipy.io as sio

        self.src_dir = os.path.join(dataset_dir, subset)
        self.npy_dir = os.path.join(dataset_dir, f"npy-{out_size}", subset)
        os.makedirs(self.npy_dir, exist_ok=True)
        mat = sio.loadmat(os.path.join(self.src_dir, "joint_data.mat"))
        self.joints = np.stack(
            [mat["joint_xyz"][v] for v in range(num_views)], axis=0
        ).astype(np.float32)  # (V, N, 36, 3)
        self.joints[..., 1] *= -1  # flip y (nyu_generator.py:32)
        self.num_views = num_views
        self.num_samples = self.joints.shape[1]
        self.out_size = out_size
        self.cube_mm = cube_mm

    def _names(self, idx: int) -> list[str]:
        return [
            f"depth_{v + 1}_{idx + 1:07d}.png" for v in range(self.num_views)
        ]

    def generate(self, samples_per_shard: int = 1000, workers: int | None = None,
                 use_native: bool = True):
        """Produce all shards. PNG decode + crop runs on the native C++
        thread pool when available (spherehand_torch/data/native.py), else on a
        Python process pool."""
        from spherehand_torch.data import native

        native_ok = use_native and native.available()
        workers = workers or max(os.cpu_count() - 1, 1)
        num_shards = self.num_samples // samples_per_shard + 1
        for shard in range(num_shards):
            start = shard * samples_per_shard
            end = min(start + samples_per_shard, self.num_samples)
            if start >= end:
                break
            if native_ok:
                dms, joint_poses, camera_poses = self._prepare_range_native(
                    start, end
                )
            else:
                dms, joint_poses, camera_poses = self._prepare_range_python(
                    start, end, workers
                )
            self._write_shard(f"mv_data_{shard}", dms, joint_poses, camera_poses)
            print(f"shard {shard}: samples [{start}, {end})"
                  f"{' [native]' if native_ok else ''}")

    def _prepare_range_native(self, start: int, end: int):
        from spherehand_torch.data import native

        n = end - start
        paths, centers = [], []
        for i in range(start, end):
            for v, name in enumerate(self._names(i)):
                paths.append(os.path.join(self.src_dir, name))
                centers.append(self.joints[v, i, 32])
        crops, failures = native.decode_crop_batch(
            paths,
            np.asarray(centers, np.float32),
            cube=self.cube_mm,
            out_size=self.out_size,
        )
        if failures:
            raise IOError(f"{failures} depth PNGs failed to decode")
        dms = crops.reshape(n, self.num_views, self.out_size, self.out_size)
        joint_poses = np.stack(
            [
                self.joints[:, i] - self.joints[:, i, 32][:, None]
                for i in range(start, end)
            ]
        ).astype(np.float32)
        camera_poses = np.stack(
            [
                np.stack(
                    [np.eye(4)]
                    + [
                        kabsch_transform(joint_poses[k, v], joint_poses[k, 0])
                        for v in range(1, self.num_views)
                    ]
                )
                for k, _ in enumerate(range(start, end))
            ]
        ).astype(np.float32)
        return dms, joint_poses, camera_poses

    def _prepare_range_python(self, start: int, end: int, workers: int):
        import multiprocessing as mp

        args = [
            (
                self.src_dir,
                self._names(i),
                self.joints[:, i],
                self.cube_mm,
                self.out_size,
            )
            for i in range(start, end)
        ]
        # spawn: the caller's process may run threads (torch), and forking
        # one is unsafe; the workers import this module afresh.
        with mp.get_context("spawn").Pool(workers) as pool:
            results = pool.map(_prepare_sample, args)
        return (
            np.stack([r[0] for r in results]),
            np.stack([r[1] for r in results]),
            np.stack([r[2] for r in results]),
        )

    def _write_shard(self, name, dms, joint_poses, camera_poses):
        write_shard(self.npy_dir, name, dms, joint_poses, camera_poses)


def write_shard(npy_dir: str, name: str, dms: np.ndarray, joint_poses: np.ndarray,
                camera_poses: np.ndarray) -> None:
    """Write one shard ``name`` (e.g. ``mv_data_0``) under ``npy_dir``: dms
    (N, V, 64, 64) float32 mm, joint_poses (N, V, 36, 3), camera_poses
    (N, V, 4, 4)."""
    shapes = {
        "dms": dms.shape,
        "joint_poses": joint_poses.shape,
        "camera_poses": camera_poses.shape,
    }
    with open(os.path.join(npy_dir, name + "_shape.pkl"), "wb") as f:
        pickle.dump(shapes, f, protocol=pickle.HIGHEST_PROTOCOL)
    mm = np.memmap(
        os.path.join(npy_dir, name + "_dms.bat"),
        dtype="float32", mode="w+", shape=dms.shape,
    )
    mm[:] = dms
    mm.flush()
    np.save(os.path.join(npy_dir, name + "_joint_poses.npy"), joint_poses)
    np.save(os.path.join(npy_dir, name + "_camera_poses.npy"), camera_poses)


class NyuDataset:
    """Concatenated memmap shards with whole-batch gather access."""

    def __init__(self, shard_dirs: str | list[str]):
        if isinstance(shard_dirs, str):
            shard_dirs = [shard_dirs]
        self.dms: list[np.memmap] = []
        self.joint_poses: list[np.ndarray] = []
        self.camera_poses: list[np.ndarray] = []
        self.inv_camera_poses: list[np.ndarray] = []
        sizes = []
        for d in shard_dirs:
            idx = 0
            while True:
                base = os.path.join(d, f"mv_data_{idx}")
                if not os.path.exists(base + "_shape.pkl"):
                    break
                with open(base + "_shape.pkl", "rb") as f:
                    shapes = pickle.load(f)
                self.dms.append(
                    np.memmap(base + "_dms.bat", dtype="float32", mode="r",
                              shape=tuple(shapes["dms"]))
                )
                jp = np.load(base + "_joint_poses.npy")
                cp = np.load(base + "_camera_poses.npy")
                self.joint_poses.append(jp)
                self.camera_poses.append(cp)
                self.inv_camera_poses.append(
                    np.linalg.inv(cp.reshape(-1, 4, 4)).reshape(cp.shape).astype(np.float32)
                )
                sizes.append(jp.shape[0])
                idx += 1
        if not sizes:
            raise FileNotFoundError(f"no mv_data_* shards under {shard_dirs}")
        self.sizes = np.asarray(sizes)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.num_samples = int(self.offsets[-1])

    def __len__(self) -> int:
        return self.num_samples

    def gather_joints(self, indices: np.ndarray) -> np.ndarray:
        """Joints-only fetch (B, V, 36, 3) — the eval loop's host-side ground
        truth when the depth maps live device-resident (no memmap dms IO)."""
        indices = np.asarray(indices)
        shard_ids = np.searchsorted(self.offsets, indices, side="right") - 1
        local = indices - self.offsets[shard_ids]
        return np.stack(
            [self.joint_poses[s][i] for s, i in zip(shard_ids, local)]
        )

    def gather_dms(self, indices: np.ndarray) -> np.ndarray:
        """Depth-maps-only fetch (B, V, 64, 64) — for the eval image dump on
        the device-resident path, where joints were already fetched via
        gather_joints for the same indices (no redundant full-record IO)."""
        indices = np.asarray(indices)
        shard_ids = np.searchsorted(self.offsets, indices, side="right") - 1
        local = indices - self.offsets[shard_ids]
        return np.stack(
            [np.asarray(self.dms[s][i]) for s, i in zip(shard_ids, local)]
        )

    def gather(self, indices: np.ndarray):
        """Fetch a batch by global indices -> (dms, joints, poses, inv_poses)."""
        shard_ids = np.searchsorted(self.offsets, indices, side="right") - 1
        local = indices - self.offsets[shard_ids]
        dms, joints, poses, inv_poses = [], [], [], []
        for s, i in zip(shard_ids, local):
            dms.append(np.asarray(self.dms[s][i]))
            joints.append(self.joint_poses[s][i])
            poses.append(self.camera_poses[s][i])
            inv_poses.append(self.inv_camera_poses[s][i])
        return (
            np.stack(dms),
            np.stack(joints),
            np.stack(poses),
            np.stack(inv_poses),
        )


class NyuLoader:
    """Batched epoch iterator: shuffled index plan + memmap gather.

    Drops the trailing ragged batch, as the JAX package does (the reference
    DataLoader keeps it): every step sees the batch geometry it was built
    for, and with bs 25 over ~72k samples the loss of <25 samples/epoch is
    noise.

    The shuffle permutation derives from ``(seed, epoch)``, so each epoch
    sees a fresh order (the reference's DataLoader semantics — one torch
    generator across the run) AND a resumed run replays the exact order of
    the epochs it re-enters, which torch does not guarantee.
    """

    def __init__(self, dataset: NyuDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, epoch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def iter_index_batches(self) -> Iterator[np.ndarray]:
        """The epoch's index plan only — shared by the host gather path and
        the device-resident path (engine), so both see identical batches."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rs = np.random.RandomState(
                np.asarray([self.seed & 0x7FFFFFFF, self.epoch], np.uint32)
            )
            rs.shuffle(order)
        for b in range(len(self)):
            yield order[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self) -> Iterator:
        for idx in self.iter_index_batches():
            yield self.dataset.gather(idx)
