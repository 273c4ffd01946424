"""The int8 cross-pod all-reduce (``optim.compress.compressed_psum_pod``)
on a (2, 2, 1) ``pod`` × ``data`` × ``model`` gloo mesh of four spawned
ranks, held against the reference's function on the same inputs: the
reference runs in a subprocess with four forced host devices
(``conftest.run_subprocess``), as its own ``test_compress.py`` does.

The reference's ``shard_map`` takes each leaf replicated (``P()``), so
every pod holds the same values; there the port's mean and new error
state must equal the reference's bit for bit, over several steps of
error feedback.  With a different gradient on each pod (which the
reference's replicated input cannot express) the port's mean is held to
the reference's formula in NumPy."""
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.optim import compress as TC

from _torch_ranks import load_rank, run_ranks

STEPS = 3

REF_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_host_mesh
from repro.optim.compress import ErrorFeedbackState, compressed_psum_pod
inp = np.load({inputs!r})
g = {{"w": jnp.asarray(inp["w"]), "b": {{"c": jnp.asarray(inp["c"])}}}}
st = ErrorFeedbackState({{"w": jnp.zeros_like(g["w"]),
                          "b": {{"c": jnp.zeros_like(g["b"]["c"])}}}})
mesh = make_host_mesh((2, 2, 1), ("pod", "data", "model"))
outs = {{}}
with mesh:
    for i in range({steps}):
        out, st = compressed_psum_pod(g, st, mesh)
        outs[f"w{{i}}"], outs[f"c{{i}}"] = np.asarray(out["w"]), np.asarray(out["b"]["c"])
        outs[f"ew{{i}}"], outs[f"ec{{i}}"] = np.asarray(st.err["w"]), np.asarray(st.err["b"]["c"])
np.savez({outputs!r}, **outs)
print("OK")
"""

PORT_RANK = """
import numpy as np
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.compress import compressed_psum_pod, init_error_feedback
inp = np.load(os.path.join(OUT, "inputs.npz"))
mesh = make_host_mesh((2, 2, 1), ("pod", "data", "model"))
pod = mesh.coordinate()["pod"]
scale = float(inp["pod_scale"][pod])
g = {"w": torch.from_numpy(inp["w"]) * scale,
     "b": {"c": torch.from_numpy(inp["c"]) * scale}}
st = init_error_feedback(g)
outs = {}
for i in range(int(inp["steps"])):
    out, st = compressed_psum_pod(g, st, mesh)
    outs[i] = (out, st.err)
torch.save({"outs": outs, "pod": pod}, f"{OUT}/rank{RANK}.pt")
"""


def _inputs(tmp, pod_scale):
    rng = np.random.default_rng(0)
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, w=(rng.standard_normal(16) * 0.1).astype(np.float32),
             c=rng.standard_normal((3, 5)).astype(np.float32),
             pod_scale=np.asarray(pod_scale, np.float32),
             steps=np.asarray(STEPS))
    return np.load(path)


def test_equals_the_reference_bit_for_bit(tmp_path, subproc):
    """Replicated gradients on both pods: the port's mean and error state
    after each of three steps equal the reference's, bit for bit."""
    _inputs(tmp_path, [1.0, 1.0])
    r = subproc(REF_CODE.format(inputs=str(tmp_path / "inputs.npz"),
                                outputs=str(tmp_path / "ref.npz"),
                                steps=STEPS), devices=4)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = np.load(tmp_path / "ref.npz")
    run_ranks(PORT_RANK, 4, tmp_path)
    for rank in range(4):
        outs = load_rank(tmp_path, rank)["outs"]
        for i in range(STEPS):
            out, err = outs[i]
            np.testing.assert_array_equal(out["w"].numpy(), ref[f"w{i}"])
            np.testing.assert_array_equal(out["b"]["c"].numpy(), ref[f"c{i}"])
            np.testing.assert_array_equal(err["w"].numpy(), ref[f"ew{i}"])
            np.testing.assert_array_equal(err["b"]["c"].numpy(),
                                          ref[f"ec{i}"])


def _quant(x):
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))) / \
        np.float32(127.0)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


def test_different_pods_take_the_mean_with_one_int8_payload(tmp_path):
    """Pod 1's gradient is 3 × pod 0's: the first step's mean is the
    reference's ``summed · (scale_sum / npod) / npod`` over the two pods'
    int8 values and f32 scales, the same on every rank, within a
    quantization step of the true mean (2 × pod 0's); each pod keeps its
    own residual."""
    inp = _inputs(tmp_path, [1.0, 3.0])
    run_ranks(PORT_RANK, 4, tmp_path)
    for name in ("w", "c"):
        parts = [_quant(inp[name] * s) for s in (np.float32(1), np.float32(3))]
        summed = (parts[0][0].astype(np.int32) + parts[1][0]).astype(
            np.float32)
        scale_sum = parts[0][1] + parts[1][1]
        npod = np.float32(2)
        want = summed * (scale_sum / npod) / npod
        for rank in range(4):
            got = load_rank(tmp_path, rank)
            out, err = got["outs"][0]
            leaf = out["w"] if name == "w" else out["b"]["c"]
            np.testing.assert_array_equal(leaf.numpy(), want)
            np.testing.assert_allclose(leaf.numpy(), 2 * inp[name],
                                       atol=float(scale_sum))
            e = err["w"] if name == "w" else err["b"]["c"]
            q, s = parts[got["pod"]]
            np.testing.assert_array_equal(
                e.numpy(), inp[name] * inp["pod_scale"][got["pod"]]
                - q.astype(np.float32) * s)


def test_a_mesh_without_a_pod_axis_raises():
    g = {"w": torch.zeros(4)}
    with pytest.raises(ValueError, match="pod"):
        TC.compressed_psum_pod(g, TC.init_error_feedback(g),
                               Mesh((2, 2), ("data", "model")))
