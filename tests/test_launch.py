"""Multi-host execution path (parallel/launch.py).

Two layers of coverage, per SURVEY.md §4's "distributed without a cluster"
strategy:

- single-process unit tests of the per-host construction helpers on the
  8-virtual-device CPU mesh (row maps, row-windowed rays, global assembly);
- a REAL 2-process ``jax.distributed`` test: subprocess-spawned workers with
  a localhost coordinator run a sharded fit over the global 2×2-device mesh,
  and the parent asserts loss parity across processes *and* against the
  single-process run, plus exactly-one checkpoint writer (host-0 gating).
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sdf3d_tpu as s
from sdf3d_tpu.camera import camera_rays, camera_rays_for_rows
from sdf3d_tpu.fit import FitConfig, fit_scene
from sdf3d_tpu.parallel import launch
from sdf3d_tpu.parallel.mesh import make_mesh
from sdf3d_tpu.parallel.shard_render import interleave_rows

CFG = dataclasses.replace(s.REFERENCE_CONFIG, width=64, height=48)
CAM = s.Camera.reference()


class TestRowMaps:
    def test_contiguous_identity(self):
        rows = launch.abs_rows_for_block(8, 20, height=48, n=4)
        np.testing.assert_array_equal(rows, np.arange(8, 20))

    @pytest.mark.parametrize("n,th", [(4, 4), (2, 8), (8, 2)])
    def test_interleaved_matches_interleave_rows(self, n, th):
        """abs_rows_for_block inverts exactly the interleave_rows permutation:
        permuted-global row g holds absolute row abs_rows_for_block(g)."""
        H = 64
        x = jnp.arange(H, dtype=jnp.float32)
        permuted = np.asarray(interleave_rows(x, n, th))
        for lo, hi in [(0, H), (H // 4, H // 2), (H - 5, H)]:
            rows = launch.abs_rows_for_block(lo, hi, H, n, interleaved=True, tile_h=th)
            np.testing.assert_array_equal(rows, permuted[lo:hi])

    def test_interleaved_requires_tile_h(self):
        with pytest.raises(ValueError, match="tile_h"):
            launch.abs_rows_for_block(0, 8, 48, 4, interleaved=True)


class TestRowWindowedRays:
    def test_subset_matches_full_bundle(self):
        o_full, d_full = camera_rays(CAM, CFG.width, CFG.height, CFG.ray_mode)
        rows = np.asarray([0, 7, 13, 47, 30])
        o, d = camera_rays_for_rows(CAM, CFG.width, CFG.height, rows, CFG.ray_mode)
        np.testing.assert_array_equal(np.asarray(o), np.asarray(o_full)[rows])
        np.testing.assert_array_equal(np.asarray(d), np.asarray(d_full)[rows])


class TestRowSharded:
    def test_assembles_global_array(self, cpu_devices):
        mesh = make_mesh(cpu_devices, n_devices=4)
        full = np.arange(48 * 5, dtype=np.float32).reshape(48, 5)
        arr = launch.row_sharded(mesh, (48, 5), lambda lo, hi: full[lo:hi])
        np.testing.assert_array_equal(np.asarray(arr), full)
        assert len(arr.sharding.device_set) == 4

    def test_block_shape_validated(self, cpu_devices):
        mesh = make_mesh(cpu_devices, n_devices=4)
        with pytest.raises(ValueError, match="returned shape"):
            launch.row_sharded(mesh, (48, 5), lambda lo, hi: np.zeros((1, 5)))

    def test_fit_arrays_match_full_construction(self, cpu_devices):
        mesh = make_mesh(cpu_devices, n_devices=4)
        target = np.random.default_rng(0).random((48, 64, 3)).astype(np.float32)
        o, d, t = launch.fit_arrays(mesh, CAM, CFG, target)
        o_full, d_full = camera_rays(CAM, CFG.width, CFG.height, CFG.ray_mode)
        np.testing.assert_array_equal(np.asarray(o), np.asarray(o_full))
        np.testing.assert_array_equal(np.asarray(d), np.asarray(d_full))
        np.testing.assert_array_equal(np.asarray(t), target)

    def test_fit_arrays_interleaved_layout(self, cpu_devices):
        mesh = make_mesh(cpu_devices, n_devices=4)
        th = 4
        target = np.random.default_rng(1).random((48, 64, 3)).astype(np.float32)
        o, d, t = launch.fit_arrays(mesh, CAM, CFG, target, interleaved=True, tile_h=th)
        o_full, d_full = camera_rays(CAM, CFG.width, CFG.height, CFG.ray_mode)
        np.testing.assert_array_equal(
            np.asarray(t), np.asarray(interleave_rows(jnp.asarray(target), 4, th))
        )
        np.testing.assert_array_equal(
            np.asarray(o), np.asarray(interleave_rows(o_full, 4, th))
        )
        np.testing.assert_array_equal(
            np.asarray(d), np.asarray(interleave_rows(d_full, 4, th))
        )


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.slow
class TestTwoProcessFit:
    """The real thing: 2 OS processes × 2 CPU devices, gloo collectives."""

    def test_two_process_fit_matches_single_process(self, tmp_path, cpu_devices):
        port = _free_port()
        worker = pathlib.Path(__file__).parent / "_launch_worker.py"
        repo = str(pathlib.Path(__file__).resolve().parents[1])
        env = os.environ.copy()
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        extra = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        env["PYTHONPATH"] = os.pathsep.join([repo] + extra)
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(port), str(i), str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in (0, 1)
        ]
        outs = [p.communicate(timeout=420)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

        results = []
        for i in (0, 1):
            with open(tmp_path / f"out_p{i}.json") as f:
                results.append(json.load(f))

        # Replicated state: every process observes identical losses.
        assert results[0]["losses"] == results[1]["losses"]
        assert results[0]["radius"] == pytest.approx(results[1]["radius"], rel=1e-6)
        # Host-0 gating: exactly one checkpoint writer.
        assert results[0]["ckpt_state_written"] is True
        assert results[1]["ckpt_state_written"] is False
        assert not (tmp_path / "ckpt_p1" / "state.npz").exists()

        # Parity vs the same fit on a single-process 4-device mesh.
        mesh = make_mesh(cpu_devices, n_devices=4)
        target = np.asarray(
            s.render(s.reference_scene(), CAM, s.reference_light(), s.reference_material(), CFG)
        )
        scene0 = s.sdf.union(
            s.sdf.ground_plane(),
            s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25),
        )
        ref = fit_scene(
            target, scene0, CAM, s.reference_light(), s.reference_material(), CFG,
            FitConfig(steps=4, learning_rate=1e-2, log_every=2),
            mesh=mesh,
        )
        np.testing.assert_allclose(
            np.asarray(results[0]["losses"]), np.asarray(ref.losses), rtol=1e-5
        )

        # --- Resume with an ASYMMETRIC checkpoint view (the real multi-host
        # hazard): only process 0 ever wrote a checkpoint, so on re-run
        # process 1 finds nothing locally.  fit_scene must broadcast process
        # 0's restored state so both resume at the same step — without it,
        # the processes issue different numbers of collectives and hang.
        first_radius = results[0]["radius"]
        port2 = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(port2), str(i), str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in (0, 1)
        ]
        outs = [p.communicate(timeout=420)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, f"resume worker failed:\n{out[-3000:]}"
        resumed = []
        for i in (0, 1):
            with open(tmp_path / f"out_p{i}.json") as f:
                resumed.append(json.load(f))
        # Fully-trained checkpoint: both processes resume at step 4 and run 0
        # new steps — including process 1, whose local dir is empty.
        assert resumed[0]["steps_run"] == 0
        assert resumed[1]["steps_run"] == 0
        assert resumed[0]["radius"] == pytest.approx(first_radius, rel=1e-6)
        assert resumed[1]["radius"] == pytest.approx(first_radius, rel=1e-6)
        # Resumed loss history is the logged-cadence history, NOT inflated to
        # step-count length with zeros (log_every=2 → 4 steps log 3 entries).
        for r in resumed:
            assert len(r["losses"]) == len(results[0]["losses"])
            assert r["losses"] == pytest.approx(results[0]["losses"], rel=1e-6)
