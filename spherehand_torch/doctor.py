"""Checkout doctor for the port: one PASS/FAIL line a layer, the
counterpart of the JAX package's ``tools/doctor.py``.

Checks: Python dependencies; the bundled assets; the device; kinematics and
the render; a tiny synthetic train step; a data-parallel group (two gloo
ranks, spawned, sum one tensor on the device); the serving API over two
replicas on a batch the device count does not divide (the padding path);
the shard loader (a shard written and read back bit for bit; whether the
native PNG decoder built or its numpy fallback serves); on the card also
the CUDA kernels' build.

Usage:
    python -m spherehand_torch.doctor          # on the card
    python -m spherehand_torch.doctor --cpu    # no card needed

Prints ``N/M checks passed`` and exits non-zero on any FAIL.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120
_SUM_CHILD = r"""
import sys, torch
from spherehand_torch.parallel.mesh import form_group, leave_group
rank, init, device = int(sys.argv[1]), sys.argv[2], sys.argv[3]
group = form_group(rank, 2, device, init, backend="gloo", timeout_s=60)
try:
    t = torch.full((4,), float(rank + 1), device=group.device)
    group.all_reduce_(t)
    if t.tolist() != [3.0] * 4:
        raise RuntimeError(f"the sum over 2 ranks gave {t.tolist()}")
    print(group.backend, group.device)
finally:
    leave_group()
"""


class Doctor:
    """Runs the checks on ``device`` ("cpu" or "cuda") and records them."""

    def __init__(self, device: str):
        self.device = device
        self.results: list[tuple[str, bool, str]] = []

    def check(self, name: str, fn) -> bool:
        t0 = time.perf_counter()
        try:
            msg = fn() or "ok"
        except Exception as exc:  # noqa: BLE001 - each check reports, the run goes on
            self.results.append((name, False, repr(exc)))
            print(f"  FAIL  {name}: {exc!r}", flush=True)
            return False
        self.results.append((name, True, msg))
        print(f"  PASS  {name}: {msg} ({time.perf_counter() - t0:.1f}s)", flush=True)
        return True

    # ---------------------------------------------------------------- checks
    def deps(self) -> str:
        import numpy
        import torch

        return f"torch {torch.__version__}, numpy {numpy.__version__}"

    def assets(self) -> str:
        import numpy as np

        root = os.path.join(ROOT, "assets")
        names = ["hand_model.npz", "hand_model_lite.npz", "pose_vae.npz", "pose_denoiser.npz",
                 "pose_prior_pca.npz", os.path.join("pretrained", "synthetic_params.npz")]
        missing = [n for n in names if not os.path.exists(os.path.join(root, n))]
        if missing:
            raise FileNotFoundError(f"missing assets: {missing}")
        with np.load(os.path.join(root, "hand_model.npz")) as hand:
            faces = hand["faces"].shape[0]
        if faces != 3382:
            raise ValueError(f"full mesh has {faces} faces, not 3382")
        return f"{len(names)} asset files, full mesh {faces} faces"

    def device_info(self) -> str:
        import torch

        from spherehand_torch.device import resolve_device

        dev = resolve_device(self.device)
        if dev.type == "cuda":
            return f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(dev)}"
        return f"cpu, {torch.get_num_threads()} threads"

    def render(self) -> str:
        import torch

        from spherehand_torch.data.sampler import sample_poses
        from spherehand_torch.hand.assets import load_hand_model
        from spherehand_torch.hand.kinematics import forward_kinematics
        from spherehand_torch.render.raster import render_depth_64

        model = load_hand_model(device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        dm = render_depth_64(model, forward_kinematics(model, sample_poses(gen, 2)),
                             torch.ones(2, device=self.device)).cpu()
        fg = dm < 99.0
        if not bool(fg.any()):
            raise ValueError("no foreground pixels rendered")
        mean = float(dm[fg].mean())
        if not -150.0 < mean < 90.0:
            raise ValueError(f"foreground mean {mean} mm outside the crop")
        return f"64x64 depth ok, {int(fg.sum())} fg px across 2 frames"

    def train_step(self) -> str:
        import torch

        from spherehand_torch.hand.assets import load_hand_model
        from spherehand_torch.train.config import EngineConfig
        from spherehand_torch.train.steps import build_steps

        cfg = EngineConfig(synt_batch=2, real_batch=1, num_stacks=1)
        fns = build_steps(cfg, load_hand_model(device=self.device, lite=True))
        state = fns.init_state(torch.Generator().manual_seed(0))
        gen = torch.Generator(device=self.device).manual_seed(1)
        _, metrics = fns.synt_step(state, 1e-3, fns.draw(gen, real=False))
        loss = float(metrics["loss"])
        if not loss > 0.0 or loss != loss:
            raise ValueError(f"synthetic loss {loss}")
        return f"synt loss {loss:.1f}"

    def group(self) -> str:
        with tempfile.TemporaryDirectory(prefix="spherehand_doctor_") as tmp:
            init = "file://" + os.path.join(tmp, "rendezvous")
            procs = [subprocess.Popen([sys.executable, "-c", _SUM_CHILD, str(r), init,
                                       self.device], cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True) for r in range(2)]
            try:
                logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
        if any(p.returncode for p in procs):
            raise RuntimeError(f"ranks failed: {[log[-1500:] for log in logs]}")
        return f"2 ranks, {logs[0].strip().splitlines()[-1]}: all_reduce summed"

    def serving(self) -> str:
        import numpy as np

        from spherehand_torch.infer import PoseEstimator, load_params_npz

        params = load_params_npz(os.path.join(ROOT, "assets", "pretrained",
                                              "synthetic_params.npz"))
        dms = np.full((3, 64, 64), 100.0, np.float32)  # 2 replicas + 1: the padding path
        dms[:, 24:40, 24:40] = 40.0
        est = PoseEstimator(params, serve_chunk=2, devices=[self.device, self.device])
        joints = est.predict(dms)
        if joints.shape != (3, 41, 3) or not np.isfinite(joints).all():
            raise ValueError(f"joints {joints.shape}, finite {np.isfinite(joints).all()}")
        return f"predict ok: {joints.shape[0]} crops over 2 replicas"

    def shards(self) -> str:
        import numpy as np

        from spherehand_torch.data import native
        from spherehand_torch.data.nyu import NyuDataset, write_shard

        rng = np.random.RandomState(0)
        dms = rng.uniform(20, 100, (3, 3, 64, 64)).astype(np.float32)
        joints = rng.uniform(-80, 80, (3, 3, 36, 3)).astype(np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (3, 3, 1, 1))
        with tempfile.TemporaryDirectory(prefix="spherehand_doctor_") as tmp:
            write_shard(tmp, "mv_data_0", dms, joints, poses)
            got = NyuDataset(tmp).gather(np.array([2, 0]))
        if not (np.array_equal(got[0], dms[[2, 0]]) and np.array_equal(got[1], joints[[2, 0]])):
            raise ValueError("a shard read back differs from what was written")
        try:
            native.load_library()
            decoder = "native PNG decoder built"
        except Exception as exc:  # noqa: BLE001 - the numpy fallback serves without it
            decoder = f"native PNG decoder not built ({type(exc).__name__}), numpy fallback"
        return f"shard written and read back bit for bit; {decoder}"

    def kernels(self) -> str:
        from spherehand_torch import cuda_build

        built = cuda_build.build_all(cuda_build.SOURCES)
        return ", ".join(os.path.basename(path) for path, _ in built.values())

    def run(self) -> int:
        print(f"spherehand_torch doctor ({self.device})", flush=True)
        self.check("python deps", self.deps)
        self.check("assets", self.assets)
        ok_dev = self.check("device", self.device_info)
        if self.device == "cuda":
            self.check("CUDA kernels", self.kernels)
        self.check("kinematics + render", self.render)
        self.check("train step (tiny)", self.train_step)
        self.check("data-parallel group", self.group)
        self.check("serving API", self.serving)
        self.check("shard loader", self.shards)
        failed = [name for name, ok, _ in self.results if not ok]
        print(f"\n{len(self.results) - len(failed)}/{len(self.results)} checks passed"
              + (f" - FAILED: {', '.join(failed)}" if failed else ""), flush=True)
        if not ok_dev:
            print("hint: no usable card; rerun with --cpu to check the install without one")
        return 1 if failed else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run every check on the CPU")
    args = ap.parse_args(argv)
    return Doctor("cpu" if args.cpu else "cuda").run()


if __name__ == "__main__":
    sys.exit(main())
