"""Neural SDF: an MLP distance field as a scene node (matrix-unit model family).

The retrieved literature (PAPERS.md — IGR-style geometric initialization,
differentiable neural-SDF rendering) motivates the third model family beside
analytic CSG and voxel grids: a small MLP ``f(p) -> distance``.  This is the
family that engages the matrix units — every SDF evaluation is a chain of
matmuls over the ray batch (the analytic families are pure elementwise
code).

- **Geometric initialization** (Gropp et al. 2020, "Implicit Geometric
  Regularization"): hidden layers ~ N(0, sqrt(2/fan_in)), final layer mean
  sqrt(pi/fan_in) with bias −r, softplus(β) activations — the network *is*
  approximately ``|p| − r`` at init, so it marches correctly from step 0.
- **Distillation** (:func:`distill`): regress the MLP onto any other scene
  node (analytic CSG, voxel grid) over a sample box — the quick way to get
  a neural model of an authored shape; after that, ``fit_scene`` fine-tunes
  it from images like any other scene pytree.
- Engines: full support on the XLA paths (render / render_diff / sharded /
  fit).  The fused Pallas kernel's scene compiler loads parameters as
  scalars — the wrong home for weight matrices — so neural scenes raise its
  standard no-emitter error and use the XLA engine, where the MLP runs as
  matrix products.

Matmul precision is a static knob on the node (see :class:`NeuralSDF`):
JAX's default float32 matmul precision may round operands (TF32 on GPUs,
about three decimal digits — at the edge of the ε = 0.01 surface band), so
the default asks for ``"high"``.
"""

from __future__ import annotations

from sdf3d_tpu import pytree as struct
import jax
import jax.numpy as jnp
import numpy as np

from sdf3d_tpu.sdf.node import SDFNode, as_f32


@struct.dataclass
class NeuralSDF(SDFNode):
    """MLP distance field ``f(p) -> signed distance``.

    ``weights`` / ``biases``: tuples of layer parameters, shapes
    ``(3, H), (H, H), ..., (H, 1)`` and ``(H,), ..., (1,)``.
    ``beta``: softplus sharpness (static-ish scalar leaf; ~100 ≈ smooth ReLU).
    ``precision``: matmul precision (static), passed to ``jnp.dot``.
    ``"high"`` is the default; ``"highest"`` is full float32;
    ``"default"`` lets the backend round operands (TF32 on GPUs), usable
    but close to the ε = 0.01 surface band.
    """

    weights: tuple
    biases: tuple
    beta: jnp.ndarray  # ()
    precision: str = struct.field(pytree_node=False, default="high")

    def distance(self, p: jnp.ndarray) -> jnp.ndarray:
        x = p
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = jnp.dot(x, w, precision=self.precision) + b
            if i < n - 1:
                # softplus(beta*x)/beta: smooth ReLU with exact-ish identity
                # for large |x| (numerically stable via jax.nn.softplus).
                x = jax.nn.softplus(self.beta * x) / self.beta
        return x[..., 0]


def neural_sdf(
    key: jax.Array | int = 0,
    hidden: int = 64,
    depth: int = 3,
    radius: float = 0.5,
    beta: float = 100.0,
) -> NeuralSDF:
    """Geometrically initialized MLP SDF ≈ sphere of ``radius`` at origin.

    ``depth`` counts weight layers (≥ 2): ``3 → hidden×(depth−1) → 1``.
    """
    if depth < 2:
        raise ValueError("depth must be >= 2 (input and output layers)")
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    dims = [3] + [hidden] * (depth - 1) + [1]
    weights, biases = [], []
    for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        key, sub = jax.random.split(key)
        if i == depth - 1:
            # Final layer: constant sqrt(pi/fan_in) (+tiny noise), bias
            # -radius (IGR geometric init) => f(p) ~ |p| - radius.
            w = jnp.sqrt(jnp.pi / fan_in) + 1e-6 * jax.random.normal(sub, (fan_in, fan_out))
            b = jnp.full((fan_out,), -radius)
        else:
            # Hidden: N(0, sqrt(2)/sqrt(fan_out)) — the IGR scaling that
            # keeps |h| ~ |p| through softplus layers (sqrt(2/fan_in) He
            # init overshoots the field magnitude ~6x here).
            w = jax.random.normal(sub, (fan_in, fan_out)) * (jnp.sqrt(2.0) / jnp.sqrt(fan_out))
            b = jnp.zeros((fan_out,))
        weights.append(w.astype(jnp.float32))
        biases.append(b.astype(jnp.float32))
    return NeuralSDF(weights=tuple(weights), biases=tuple(biases), beta=as_f32(beta))


def distill(
    model: NeuralSDF,
    target: SDFNode,
    key: jax.Array | int = 0,
    steps: int = 500,
    batch: int = 4096,
    learning_rate: float = 1e-3,
    lo=(-1.0, -1.0, -1.0),
    hi=(1.0, 1.0, 1.0),
    surface_focus: float = 0.5,
    eikonal_weight: float = 0.1,
) -> tuple[NeuralSDF, list]:
    """Regress ``model`` onto ``target.distance`` over the box ``[lo, hi]``.

    Loss per step: MSE to the target distances on a fresh random batch
    (a ``surface_focus`` fraction of samples is drawn near the target's
    surface by rejection-free perturbation of uniform samples along the
    target gradient) plus an eikonal term ``(|∇f| − 1)²`` that keeps the
    learned field metrically a distance (IGR regularizer — without it the
    MLP matches values but its gradient magnitude drifts and sphere tracing
    over/under-steps).  Runs as one ``lax.scan`` (single dispatch).
    Returns ``(fitted_model, losses)`` with one loss value per step.
    """
    import optax

    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    lo = as_f32(lo)
    hi = as_f32(hi)
    opt = optax.adam(learning_rate)

    n_near = int(batch * surface_focus)

    def sample_points(k):
        k1, k2 = jax.random.split(k)
        pts = lo + (hi - lo) * jax.random.uniform(k1, (batch, 3))
        if n_near:
            # Project a slice of the uniform samples toward the surface:
            # p' = p - d(p)·∇d(p) lands near the zero set for a true SDF.
            sl = pts[:n_near]
            d = target.distance(sl)
            g = jax.grad(lambda q: jnp.sum(target.distance(q)))(sl)
            near = sl - d[:, None] * g
            jitter = 0.05 * jax.random.normal(k2, near.shape)
            pts = jnp.concatenate([near + jitter, pts[n_near:]], axis=0)
        return pts

    def loss_fn(m, pts):
        d_t = target.distance(pts)
        d_m = m.distance(pts)
        mse = jnp.mean((d_m - d_t) ** 2)
        if eikonal_weight > 0.0:
            g = jax.grad(lambda q: jnp.sum(m.distance(q)))(pts)
            eik = jnp.mean((jnp.sqrt(jnp.sum(g * g, axis=-1) + 1e-12) - 1.0) ** 2)
            mse = mse + eikonal_weight * eik
        return mse

    @jax.jit
    def run(m, key):
        opt_state = opt.init(m)

        def body(carry, k):
            m_, st = carry
            pts = sample_points(k)
            loss, grads = jax.value_and_grad(loss_fn)(m_, pts)
            updates, st = opt.update(grads, st, m_)
            m_ = optax.apply_updates(m_, updates)
            return (m_, st), loss

        keys = jax.random.split(key, steps)
        (m, _), losses = jax.lax.scan(body, (m, opt_state), keys)
        return m, losses

    fitted, losses = run(model, key)
    return fitted, [float(x) for x in np.asarray(losses)]
