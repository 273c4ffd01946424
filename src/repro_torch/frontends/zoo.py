"""The bundled model zoo: real CNN topologies through the importer path.

Three classifier-shaped models exercise everything the paper suite's
synthetic kernels do not — conv→dense transitions (flatten), deep
pool pyramids, and residual trunks feeding a head:

* ``lenet5``          — the classic 5-layer LeNet (SAME-padding
                        variant: this stack's convs are 'same', so the
                        32→28→14→10→5 VALID cascade becomes
                        32→32→16→16→8), conv/pool ×2 → flatten →
                        three dense layers;
* ``tiny_vgg_32``     — a VGG-style double-conv pyramid at 32²,
                        (conv·conv·pool)×2 → flatten → dense head;
* ``edge_residual_32``— two residual blocks with an avg-pool and a
                        dense head — the skip-connection model an edge
                        deployment actually ships;
* ``resnet_mini_16``  — a ResNet-18-flavoured strided trunk: stride-1
                        stem, two stride-2 SAME downsample convs each
                        followed by an identity residual block, then a
                        global average pool and the dense head — the
                        strided streaming conv path end to end.

Every entry is a plain builder graph (so the whole pass pipeline,
partitioner, and both backends apply unchanged), is registered in the
benchmark suite (``repro_torch.api.suite()`` → per-target BENCH_smoke rows),
and round-trips through the model-card format —
``python -m repro_torch zoo --export DIR`` writes the cards
(``examples/lenet5.json`` is exactly ``card("lenet5")``).
"""
from __future__ import annotations

import json

from repro_torch.api.builder import (
    AvgPool,
    Conv2D,
    Dense,
    Flatten,
    MaxPool,
    ReLU,
    Residual,
    Sequential,
)
from repro_torch.core.ir import DFG

from .modelcard import export_card


def lenet5(n_size: int = 32, c_in: int = 1, classes: int = 10) -> DFG:
    """LeNet-5 (SAME-padding variant): C6@5×5 → pool → C16@5×5 → pool →
    flatten → 120 → 84 → ``classes``."""
    return Sequential(
        [
            Conv2D(6, kernel=5), ReLU(), MaxPool(2),
            Conv2D(16, kernel=5), ReLU(), MaxPool(2),
            Flatten(),
            Dense(120), ReLU(),
            Dense(84), ReLU(),
            Dense(classes),
        ],
        input_shape=(1, n_size, n_size, c_in),
        name="lenet5",
    ).build()


def tiny_vgg(n_size: int = 32, c_in: int = 3, classes: int = 10) -> DFG:
    """A VGG-flavoured double-conv pyramid: 16·16/pool → 32·32/pool →
    flatten → 64 → ``classes``."""
    return Sequential(
        [
            Conv2D(16), ReLU(), Conv2D(16), ReLU(), MaxPool(2),
            Conv2D(32), ReLU(), Conv2D(32), ReLU(), MaxPool(2),
            Flatten(),
            Dense(64), ReLU(),
            Dense(classes),
        ],
        input_shape=(1, n_size, n_size, c_in),
        name=f"tiny_vgg_{n_size}",
    ).build()


def edge_residual(n_size: int = 32, c: int = 16, classes: int = 10) -> DFG:
    """Residual edge model: stem conv → two residual blocks → avg-pool →
    flatten → dense head (the diamond FIFO sizing meets the classifier
    head)."""
    block = lambda: Residual([Conv2D(c), ReLU(), Conv2D(c)])  # noqa: E731
    return Sequential(
        [
            Conv2D(c), ReLU(),
            block(), ReLU(),
            block(), ReLU(),
            AvgPool(2),
            Flatten(),
            Dense(classes),
        ],
        input_shape=(1, n_size, n_size, 3),
        name=f"edge_residual_{n_size}",
    ).build()


def resnet_mini(n_size: int = 16, c: int = 8, classes: int = 10) -> DFG:
    """ResNet-18-flavoured strided trunk: stem → (stride-2 downsample
    conv → identity residual block) ×2 → global average pool → dense
    head.  Each downsample halves the map and doubles the channels; the
    global pool is an AvgPool whose window is the whole remaining map
    (the DIV exit path, floor division in the integer regime)."""
    block = lambda ch: Residual([Conv2D(ch), ReLU(), Conv2D(ch)])  # noqa: E731
    return Sequential(
        [
            Conv2D(c), ReLU(),
            Conv2D(2 * c, stride=2), ReLU(),
            block(2 * c), ReLU(),
            Conv2D(4 * c, stride=2), ReLU(),
            block(4 * c), ReLU(),
            AvgPool(n_size // 4),
            Flatten(),
            Dense(classes),
        ],
        input_shape=(1, n_size, n_size, 3),
        name=f"resnet_mini_{n_size}",
    ).build()


#: the registry the CLI (`python -m repro_torch zoo`), the benchmark suite,
#: and the tests iterate — names match each graph's DFG name
ZOO: dict[str, object] = {
    "lenet5": lenet5,
    "tiny_vgg_32": tiny_vgg,
    "edge_residual_32": edge_residual,
    "resnet_mini_16": resnet_mini,
}


def card(name: str) -> dict:
    """The model card for a zoo entry (weightless — the run path's
    deterministic random init stands in for training)."""
    if name not in ZOO:
        raise KeyError(f"unknown zoo model {name!r} — one of {sorted(ZOO)}")
    return export_card(ZOO[name]())


def card_json(name: str) -> str:
    return json.dumps(card(name), indent=2) + "\n"
