"""The plain reference against the port at smoke sizes, both in float32
on the CPU from the benchmark's weights: the last logits through the
tied head, and a train step's loss and gradients."""
import pytest
import torch

from perfbench.lib import port, tokens, weights
from perfbench.reference import adamw as RA
from perfbench.reference import lm as R
from perfbench.tests.smoke import smoke_cell

NAMES = ["granite-moe-1b-a400m.train_8x4096", "mamba2-1.3b.train_8x4096"]


@pytest.mark.parametrize("length", [37, 40])
@pytest.mark.parametrize("name", NAMES)
def test_last_logits_through_the_tied_head(name, length):
    from repro_torch.launch import steps

    cfg = smoke_cell(name, dtype="float32").config
    assert cfg["tie_embeddings"]
    toks = torch.from_numpy(tokens.token_block(5, 0, 3, length,
                                               cfg["vocab_size"]))
    tree = weights.draw(cfg, 123, "cpu")
    assert "lm_head" not in tree
    logits, _ = steps.model_prefill(tree, port.model_config(cfg),
                                    {"tokens": toks})
    ref_tree = weights.draw(cfg, 123, "cpu", as_float32=True)
    with torch.no_grad():
        h = R.forward(ref_tree, cfg, toks)
        ref = R.logits_of(ref_tree, cfg, h[:, -1])
    assert logits.shape == ref.shape == (3, cfg["vocab_size"])
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_gradients(name):
    from repro_torch.launch import steps

    cfg = smoke_cell(name, dtype="float32").config
    b = tokens.lm_batch(5, 1, 2, 32, cfg["vocab_size"])
    batch = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    loss, grads = steps._value_and_grad(port.model_config(cfg),
                                        weights.draw(cfg, 9, "cpu"), batch)
    tree = weights.draw(cfg, 9, "cpu", as_float32=True)
    for _, t in weights.leaves_with_path(tree):
        t.requires_grad_(True)
    ref = R.loss(tree, cfg, batch["tokens"], batch["labels"])
    ref.backward()
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    for (p, g), (_, t) in zip(weights.leaves_with_path(grads),
                              weights.leaves_with_path(tree)):
        assert (g - t.grad).norm() <= 1e-4 * t.grad.norm() + 1e-9, p


def test_adamw_matches_the_port():
    from repro_torch.optim import adamw

    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "grad_clip": 1.0, "warmup_steps": 2,
           "total_steps": 10, "min_lr_frac": 0.1}
    cfg = adamw.AdamWConfig(**opt)
    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(5, 3, generator=gen).to(torch.bfloat16),
         "b": torch.randn(7, generator=gen)}
    state = adamw.init(p, cfg)
    leaves = [p["a"].float(), p["b"].clone()]
    mine = RA.AdamW(opt, leaves, [torch.bfloat16, torch.float32])
    for _ in range(4):
        g = {"a": torch.randn(5, 3, generator=gen),
             "b": torch.randn(7, generator=gen) * 3}
        p, state, _ = adamw.apply(p, g, state, cfg)
        mine.step(leaves, [g["a"], g["b"]])
    assert torch.equal(p["a"].float(), leaves[0])
    torch.testing.assert_close(p["b"], leaves[1], rtol=1e-6, atol=1e-7)
