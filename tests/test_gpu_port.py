"""What the GPU build rests on outside the kernels: the in-repo pytree
dataclass, ``.npz`` checkpoints, the compile-cache location, and the entry
points that refuse to run without a GPU."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import sdf3d_tpu as s
from sdf3d_tpu import pytree
from sdf3d_tpu.checkpoint import load_checkpoint, save_checkpoint

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytree.dataclass
class _Node:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = pytree.field(pytree_node=False, default=3)


class TestPytreeDataclass:
    def test_replace_returns_updated_copy(self):
        x = _Node(jnp.ones(2), jnp.zeros(()))
        y = x.replace(b=jnp.float32(5.0))
        assert float(y.b) == 5.0 and float(x.b) == 0.0 and y.n == 3
        with pytest.raises(dataclasses.FrozenInstanceError):
            x.a = jnp.zeros(2)

    def test_static_fields_live_in_the_treedef(self):
        x = _Node(jnp.ones(2), jnp.zeros(()), n=7)
        leaves, treedef = jax.tree_util.tree_flatten(x)
        assert len(leaves) == 2
        assert jax.tree_util.tree_unflatten(treedef, leaves).n == 7
        assert treedef != jax.tree_util.tree_structure(x.replace(n=8))
        mb = s.fractal_scene(iterations=4)
        assert jax.tree_util.tree_unflatten(*reversed(jax.tree_util.tree_flatten(mb))).b.iterations == 4

    def test_jit_traces_leaves_and_keeps_static(self):
        @jax.jit
        def f(x):
            return x.a * x.n + x.b

        np.testing.assert_allclose(np.asarray(f(_Node(jnp.ones(2), jnp.float32(1.0), n=4))), [5.0, 5.0])

    def test_vmap_over_nodes(self):
        stacked = _Node(jnp.arange(6.0).reshape(3, 2), jnp.arange(3.0))
        out = jax.vmap(lambda x: jnp.sum(x.a) + x.b)(stacked)
        np.testing.assert_allclose(np.asarray(out), [1.0, 6.0, 11.0])

    def test_scene_grads_have_scene_structure(self):
        scene = s.reference_scene()
        g = jax.grad(lambda sc: jnp.sum(sc.distance(jnp.array([[0.1, 0.5, 0.0]]))))(scene)
        assert jax.tree_util.tree_structure(g) == jax.tree_util.tree_structure(scene)


class TestCheckpoint:
    @pytest.mark.parametrize("with_optimizer", [False, True])
    def test_round_trip(self, tmp_path, with_optimizer):
        scene = s.flagship_scene()
        state = (scene, optax.adam(1e-2).init(scene)) if with_optimizer else scene
        save_checkpoint(tmp_path / "ck", state, step=7, meta={"losses": [1.0, 0.5]})
        template = jax.tree_util.tree_map(jnp.zeros_like, state)
        back, manifest = load_checkpoint(tmp_path / "ck", template)
        assert manifest["step"] == 7 and manifest["losses"] == [1.0, 0.5]
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["manifest.json", "state.npz"]


class TestCompileCache:
    def test_env_dir_is_left_alone(self, tmp_path, monkeypatch):
        from sdf3d_tpu.utils import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_dir_is_fixed_under_the_repo(self, monkeypatch):
        from sdf3d_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = compile_cache.enable_compile_cache()
            assert path == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def _run_script(script: str, cwd: pathlib.Path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, str(cwd / script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_refuses_without_gpu(script):
    """Without a GPU both exit non-zero and print no result line."""
    proc = _run_script(script, REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "rays_per_second" not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
