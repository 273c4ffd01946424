"""Shared helpers of the ``tests/test_torch_*.py`` files: the port
(``repro_torch``) held against the reference package (``repro``) on the
CPU, on inputs made with NumPy and handed to both."""
import functools
import os

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ROOT = os.path.join(REPO, "src", "repro_torch")
REF_ROOT = os.path.join(REPO, "src", "repro")

TARGETS = ("kv260", "zu3eg")


@functools.lru_cache(maxsize=None)
def compiled_pair(name: str, target: str):
    """(reference artifact, port artifact) of suite graph ``name``."""
    import repro.api as japi
    import repro_torch.api as tapi

    return (
        japi.compile_graph(japi.suite()[name](), target=target),
        tapi.compile_graph(tapi.suite()[name](), target=target),
    )


def int_env(src, seed: int, lo: int = -4, hi: int = 5, dtype=np.int32):
    """(inputs, params) of small integers for a compiled source graph."""
    rng = np.random.default_rng(seed)
    inputs = {k: rng.integers(lo, hi, size=src.values[k].shape).astype(dtype)
              for k in src.graph_inputs}
    params = {n: rng.integers(lo, hi, size=v.shape).astype(dtype)
              for n, v in src.values.items() if v.is_constant}
    return inputs, params


def strip_telemetry(report) -> str:
    return str(report).split("\ntelemetry:")[0]


# ---------------------------------------------------------------------------
# the LM stack: one parameter tree for both packages
# ---------------------------------------------------------------------------

#: the dense path's tolerances (``test_torch_lm_serve.py`` gives the why)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.08, rtol=0.03)


def perturb_f32_leaves(np_tree, seed: int = 0):
    """The reference's params as NumPy, with the leaves it keeps in f32
    moved off the values they are drawn at (0, 0 and 1 for ``a_log``,
    ``dt_bias`` and ``skip_d``, which bf16 holds exactly) and ``router``
    jittered, so that a wrong cast to bf16 would change them."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "a_log":
                out[k] = (v + rng.uniform(-0.5, 0.5, v.shape)).astype(
                    np.float32)
            elif k == "dt_bias":
                out[k] = rng.uniform(-1.0, 0.5, v.shape).astype(np.float32)
            elif k == "skip_d":
                out[k] = (v + rng.uniform(-0.3, 0.3, v.shape)).astype(
                    np.float32)
            elif k == "router":
                out[k] = (v * (1 + rng.uniform(-1e-3, 1e-3, v.shape))
                          ).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(np_tree)


@functools.lru_cache(maxsize=None)
def ref_and_port(arch: str, dtype: str = "float32", seed: int = 0, **cfg_kw):
    """(reference cfg, port cfg, reference params, NumPy params, port
    params) of ``arch``'s smoke config: the reference draws the params
    (``attn_impl="pallas"``: its kernel in interpret mode), the f32
    leaves are perturbed, and both packages get the same values."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.launch import steps as JS
    from repro_torch.configs import registry as treg
    from repro_torch.models import lm as tlm

    jcfg = jreg.get_config(arch, smoke=True).with_(
        dtype=dtype, attn_impl="pallas", **cfg_kw)
    tcfg = treg.get_config(arch, smoke=True).with_(dtype=dtype, **cfg_kw)
    init = JS.model_init(jax.random.key(seed), jcfg)
    npp = perturb_f32_leaves(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), init),
        seed)
    jp = jax.tree.map(lambda n, a: jnp.asarray(n).astype(a.dtype), npp, init)
    return jcfg, tcfg, jp, npp, tlm.lm_params_from_numpy(npp, tcfg,
                                                         device="cpu")


@functools.lru_cache(maxsize=None)
def ref_lm_steps(jcfg):
    """The reference's ``lm_prefill`` and ``lm_decode``, jitted once per
    config."""
    import jax
    from repro.models import lm as jlm

    return (jax.jit(jlm.lm_prefill, static_argnums=1),
            jax.jit(jlm.lm_decode, static_argnums=1))


def to_np(x):
    """A torch tensor or a jax array as f32 NumPy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, paths joined by ``/``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def tokens(seed: int, b: int, s: int, vocab: int = 256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)
