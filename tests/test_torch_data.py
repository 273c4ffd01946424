"""The port's data pipeline (``repro_torch.data.pipeline``) held against
the reference's: the draws are NumPy's in both packages, so tokens,
labels, stub embeddings (cast to bf16 by round to nearest even in both)
and M-RoPE positions must be bit-identical, over seeds, steps and host
row ranges."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.data import pipeline as JP

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.data import pipeline as TP

from _torch_port import to_np  # noqa: F401  (sets torch threads)


@pytest.mark.parametrize("seed,step,rows", [
    (0, 0, (0, None)), (0, 1, (0, None)), (7, 3, (0, None)),
    (7, 3, (2, 5)), (123, 1000, (6, 8)), (1, 2, (0, 1)),
])
def test_lm_batch_is_bit_identical(seed, step, rows):
    kw = dict(seed=seed, vocab_size=997, seq_len=33, global_batch=8,
              host_row_start=rows[0], host_row_end=rows[1])
    got = TP.lm_batch(TP.DataConfig(**kw), step)
    want = JP.lm_batch(JP.DataConfig(**kw), step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for name in got:
        assert got[name].dtype == want[name].dtype == np.int32
        np.testing.assert_array_equal(got[name], want[name])
    n_rows = (rows[1] if rows[1] is not None else 8) - rows[0]
    assert got["tokens"].shape == (n_rows, 33)
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


def test_a_host_range_is_its_own_stream():
    """As in the reference, a host's rows are keyed by its first row, so
    rows 2-5 are not rows 2-5 of the whole batch."""
    whole = TP.lm_batch(TP.DataConfig(global_batch=8), 0)["tokens"]
    part = TP.lm_batch(TP.DataConfig(global_batch=8, host_row_start=2,
                                     host_row_end=6), 0)["tokens"]
    assert part.shape == (4, 1024)
    assert not np.array_equal(part, whole[2:6])


def test_the_iterator_resumes_bit_for_bit():
    cfg = TP.DataConfig(seed=5, global_batch=2, seq_len=16)
    it = TP.LmDataIterator(cfg)
    first = [next(it) for _ in range(3)]
    assert it.state() == {"step": 3}
    again = TP.LmDataIterator(cfg)
    again.restore({"step": 1})
    for want in first[1:]:
        got = next(again)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    ref = JP.LmDataIterator(JP.DataConfig(seed=5, global_batch=2,
                                          seq_len=16), start_step=2)
    np.testing.assert_array_equal(next(ref)["labels"], first[2]["labels"])


@pytest.mark.parametrize("arch", jreg.all_archs())
def test_batch_for_model_is_bit_identical(arch):
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = treg.get_config(arch, smoke=True)
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=24,
                                 global_batch=3)
    tshape = dataclasses.replace(TSHAPES["train_4k"], seq_len=24,
                                 global_batch=3)
    for step in (0, 4):
        got = TP.batch_for_model(tcfg, tshape, TP.DataConfig(seed=2), step,
                                 device="cpu")
        want = JP.batch_for_model(jcfg, jshape, JP.DataConfig(seed=2), step)
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            assert g.device.type == "cpu"
            assert str(g.dtype) == f"torch.{w.dtype}", name
            if w.dtype == jnp.bfloat16:
                np.testing.assert_array_equal(
                    g.view(torch.int16).numpy(),
                    np.asarray(w).view(np.int16), err_msg=name)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=name)


def test_batch_for_model_defaults_to_the_card():
    cfg = treg.get_config("llama3.2-1b", smoke=True)
    shape = dataclasses.replace(TSHAPES["train_4k"], seq_len=8,
                                global_batch=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.batch_for_model(cfg, shape, TP.DataConfig(), 0)
