"""Batched serving on the PyTorch/CUDA port: ``examples/serve_batched.py``
through ``repro_torch``.

Compile a zoo classifier through the serving artifact cache, stand up a
dynamic-batching :class:`repro_torch.serve.ServeEngine` over it on the
device, push a burst of requests and an open-loop load, and show the
observability contract: the batch coalescing, p50/p99 latency, and the
serve counters landing in the same Chrome trace as the run spans.  On
the CUDA card every batch is one launch of the streaming-conv kernel
per conv, the batch a grid axis.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py               # the CUDA card
      PYTHONPATH=src python examples/serve_batched_torch.py --device cpu  # no card
"""
import argparse
from typing import Optional

import numpy as np

from repro_torch.core.compile_driver import CompileOptions
from repro_torch.device import resolve_device
from repro_torch.frontends import zoo
from repro_torch.instrument import Tracer, use_tracer, validate_chrome_trace
from repro_torch.serve import ArtifactCache, ServeConfig, ServeEngine, run_load

MODEL = "lenet5"
CONFIG = ServeConfig(max_batch=16, latency_budget_ms=5.0)
BURST = 32
#: the open-loop level: offered QPS, requests, the generator's seed
LOAD = dict(offered_qps=200, requests=100, seed=1)


def serve_batched(device) -> dict:
    """The example on ``device``; returns the artifact, the single request
    (``x``, ``y``), the burst (``xs``, ``outs``), the engine's stats after
    the burst, the load report and the Chrome trace."""
    tracer = Tracer()
    with use_tracer(tracer):
        # artifact LRU keyed (model, CompileOptions.cache_key()) — the
        # second lookup is a hit, no second balanced-DP solve
        cache = ArtifactCache(capacity=4)
        options = CompileOptions(target="kv260")
        art = cache.get_or_compile(MODEL, zoo.ZOO[MODEL], options)
        assert cache.get_or_compile(MODEL, zoo.ZOO[MODEL], options) is art
        print(f"artifact cache: {cache.stats}")

        src = art.source
        name = src.graph_inputs[0]
        shape = src.values[name].shape
        rng = np.random.default_rng(0)

        with ServeEngine(art, CONFIG, device=device) as engine:
            # single blocking request (warms the bucket-1 path)
            x = rng.integers(-4, 5, shape, dtype=np.int32)
            y = engine(x)
            print(f"single request → logits {y.shape}")

            # a concurrent burst coalesces into batched launches
            xs = [rng.integers(-4, 5, shape, dtype=np.int32)
                  for _ in range(BURST)]
            futs = [engine.submit(xi) for xi in xs]
            outs = [f.result() for f in futs]
            stats = engine.stats
            print(f"burst of {BURST} → {stats['batches']} batches "
                  f"(max batch seen {stats['max_batch_seen']})")
            assert all(o.shape == y.shape and o.dtype == y.dtype
                       for o in outs)

            # open-loop load level: offered vs achieved QPS, p50/p99
            rep = run_load(engine, **LOAD)
            print(f"offered {rep.offered_qps:.0f} qps → achieved "
                  f"{rep.achieved_qps:.0f} qps, p50 {rep.p50_ms:.1f} ms, "
                  f"p99 {rep.p99_ms:.1f} ms, mean batch {rep.mean_batch:.1f}")

    # one trace, one tracer: the batched run:<group> spans and the serve
    # counter series together
    obj = tracer.to_chrome()
    validate_chrome_trace(obj)
    serve_events = sorted({
        e["name"] for e in obj["traceEvents"]
        if e["name"].startswith(("serve", "artifact"))
    })
    print(f"chrome trace OK: {len(obj['traceEvents'])} events, "
          f"serve series {serve_events}")
    return {"art": art, "x": x, "y": y, "xs": xs, "outs": outs,
            "stats": stats, "load": rep, "trace": obj,
            "serve_events": serve_events}


def main(argv=None, out: Optional[dict] = None) -> int:
    """``out``, when given, receives :func:`serve_batched`'s results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    res = serve_batched(resolve_device(args.device))   # no card → raises
    if out is not None:
        out.update(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
