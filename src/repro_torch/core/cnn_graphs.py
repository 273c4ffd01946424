"""The paper's evaluation kernel suite (Sec. V-A) as GenericOp DFGs.

Five kernels, matching Table II rows:

* ``conv_relu(N)``        — Conv3×3 + ReLU, input N×N
* ``cascade_conv(N)``     — (Conv3×3+ReLU) × 2
* ``residual_block(N)``   — Conv→ReLU→Conv → (+skip) → ReLU (diamond)
* ``linear()``            — 512×128 @ 128×256
* ``feed_forward()``      — 512×128 @ 128×256 → ReLU → @ 256×128

plus the beyond-paper showcases (``deep_cascade``, ``conv_pool``,
``conv_avgpool``, ``fat_conv``, ``fat_cascade``) the partitioner,
fusion, and weight-streaming work was grown on.

The paper does not publish channel counts; we fix C_in=3→C_out=16, K=3,
'same' padding — chosen so the *Vanilla* BRAM footprint reproduces the
paper's Table II values (19 blocks @32², ~707 @224²; see
benchmarks/paper_tables.py for the calibration table).  All tensors are
int8 (post-training quantization, Sec. V-A).

Every constructor is a thin wrapper over the declarative
layer-builder frontend (:mod:`repro_torch.api.builder`) — the hand-assembled
``Value``/``make_*_op`` bodies are gone, and
``tests/test_frontend.py`` pins that the builder output is
node-for-node identical to the historical hand-built graphs.
"""
from __future__ import annotations

from repro_torch.api.builder import (
    AvgPool,
    Conv2D,
    Dense,
    MaxPool,
    ReLU,
    Residual,
    Sequential,
)
from .ir import DFG

INT8 = 8


def conv_relu(n_size: int = 32, c_in: int = 3, c_out: int = 16) -> DFG:
    return Sequential(
        [Conv2D(c_out), ReLU()],
        input_shape=(1, n_size, n_size, c_in),
        name=f"conv_relu_{n_size}",
    ).build()


def cascade_conv(n_size: int = 32, c_in: int = 3, c_mid: int = 16) -> DFG:
    return Sequential(
        [Conv2D(c_mid), ReLU(), Conv2D(c_mid), ReLU()],
        input_shape=(1, n_size, n_size, c_in),
        name=f"cascade_conv_{n_size}",
    ).build()


def residual_block(n_size: int = 32, c: int = 16) -> DFG:
    """Diamond: x → conv0 → relu0 → conv1 → add(x) → relu1.

    Exercises the FIFO-depth sizing for diamond structures (Sec. IV-C)."""
    return Sequential(
        [
            Residual([Conv2D(c), ReLU(), Conv2D(c)],
                     name="add_skip", out="add_out"),
            ReLU(),
        ],
        input_shape=(1, n_size, n_size, c),
        name=f"residual_block_{n_size}",
    ).build()


def linear(batch: int = 512, d_in: int = 128, d_out: int = 256) -> DFG:
    """'Linear 512x128' (Table II): batch 512, features 128→256."""
    return Sequential(
        [Dense(d_out, out="y")],
        input_shape=(batch, d_in),
        name="linear",
    ).build()


def feed_forward(batch: int = 512, d_in: int = 128, d_hidden: int = 256) -> DFG:
    """Two cascading Linear layers with ReLU (Table II 'Feed Forward')."""
    return Sequential(
        [Dense(d_hidden, out="h"), ReLU(), Dense(d_in, out="y")],
        input_shape=(batch, d_in),
        name="feed_forward",
    ).build()


def deep_cascade(n_size: int = 32, c_in: int = 3, c_mid: int = 136,
                 n_layers: int = 4) -> DFG:
    """(Conv3×3+ReLU) × 4 with wide channels — the partitioning showcase.

    ``c_mid=136`` is chosen so that at 224² the whole-graph streaming
    plan *provably* exceeds the KV260 BRAM budget even at unroll=1
    (per-conv weights ≈73 blocks + line buffer ≈27 blocks ⇒ ~3×101+3
    blocks > 288) while every conv fits comfortably on its own — the
    graph only maps via ``repro_torch.passes.partition_layer_groups``.  At 32²
    the line buffers shrink (~5 blocks each) and the whole graph fits.
    """
    layers = [l for _ in range(n_layers) for l in (Conv2D(c_mid), ReLU())]
    return Sequential(
        layers,
        input_shape=(1, n_size, n_size, c_in),
        name=f"deep_cascade_{n_size}",
    ).build()


def conv_pool(n_size: int = 32, c_in: int = 3, c_out: int = 16) -> DFG:
    """Conv3×3 + ReLU + MaxPool2×2 (stride 2) — the conv+pool fusion
    showcase: after the pass pipeline the pool rides the conv's epilogue
    as a windowed FusedEpilogue and its process/FIFO disappear."""
    return Sequential(
        [Conv2D(c_out), ReLU(), MaxPool(2)],
        input_shape=(1, n_size, n_size, c_in),
        name=f"conv_pool_{n_size}",
    ).build()


def conv_avgpool(n_size: int = 32, c_in: int = 3, c_out: int = 16) -> DFG:
    """Conv3×3 + ReLU + AvgPool2×2 (stride 2) — the avg-pool epilogue
    showcase: fuses like the max pool but carries
    the DIV exit path on the stream-exit datapath, which the resource
    model charges as one constant-divider DSP."""
    return Sequential(
        [Conv2D(c_out), ReLU(), AvgPool(2)],
        input_shape=(1, n_size, n_size, c_in),
        name=f"conv_avgpool_{n_size}",
    ).build()


def fat_conv(n_size: int = 16, c: int = 288) -> DFG:
    """Single Conv3×3+ReLU whose weights alone exceed the KV260 BRAM
    budget (3·3·288·288 int8 ≈ 324 RAM18K > 288): no cut can help, so it
    is only schedulable via partial weight streaming — the graph that
    hard-failed with ``PartitionError`` before the weight-tiles knob."""
    return Sequential(
        [Conv2D(c), ReLU()],
        input_shape=(1, n_size, n_size, c),
        name=f"fat_conv_{n_size}",
    ).build()


def fat_cascade(n_size: int = 16, c: int = 288, n_layers: int = 2) -> DFG:
    """(Conv3×3+ReLU) × ``n_layers`` where *every* layer's weights alone
    exceed the KV260 BRAM budget (3·3·288·288 int8 ≈ 324 RAM18K > 288).

    No contiguous slice of this graph fits with resident weights, so the
    partitioner cannot fall back to "cut until everything fits": every
    candidate group needs streamed weight tiles, and the balanced DP
    must price spill boundaries against DRAM tile traffic — the
    cost-aware streaming showcase, unreachable through a
    single-node rescue."""
    layers = [l for _ in range(n_layers) for l in (Conv2D(c), ReLU())]
    return Sequential(
        layers,
        input_shape=(1, n_size, n_size, c),
        name=f"fat_cascade_{n_size}",
    ).build()


PAPER_SUITE = {
    "conv_relu_32": lambda: conv_relu(32),
    "conv_relu_224": lambda: conv_relu(224),
    "cascade_conv_32": lambda: cascade_conv(32),
    "cascade_conv_224": lambda: cascade_conv(224),
    "residual_block_32": lambda: residual_block(32),
    "residual_block_224": lambda: residual_block(224),
    "linear": linear,
    "feed_forward": feed_forward,
    "deep_cascade_32": lambda: deep_cascade(32),
    "deep_cascade_224": lambda: deep_cascade(224),
}
