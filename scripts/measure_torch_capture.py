"""The cost of capturing an epoch of the chunked route as a CUDA graph, on
one CUDA card: ``Trainer.train`` of a recipe's config (``chip_smoke``'s
full-width configs, 2 chunks of 2 epochs) several times in one process,
``EpochProgram.count_nodes`` off and on in turns.  Off, the capture
instantiates the graph inside ``capture_end`` and frees it after; on, the
graph is kept, instantiated apart and its nodes counted.

    PYTHONPATH=. python scripts/measure_torch_capture.py \\
        [--recipe production-rk4] [--runs 4]

``--recipe`` is a key of ``chip_smoke.eager_route_configs()`` or one of
"default", "production", "scaled".  Prints the card's name and power
limit, then a line a run: the capture's seconds (``capture_end``'s apart),
the instantiation's seconds and the node count where kept, the run's wall
and each epoch's time (the first chunk's holds the eager warm-up and the
capture).  Without a CUDA card it fails.
"""

import argparse
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the recipes' configs, chunk_run)
from njode_tpu_torch.utils.chunked import EpochProgram  # noqa: E402


def config(recipe: str) -> dict:
    routes = cs.eager_route_configs()
    if recipe in routes:
        return routes[recipe]
    return {"default": cs.default_config, "production": cs.production_config,
            "scaled": cs.scaled_config}[recipe](2, "capture")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recipe", default="production-rk4")
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    dev, _ = cs.device_phase()
    cfg = config(args.recipe)
    ends = []
    capture_end = torch.cuda.CUDAGraph.capture_end

    def timed_end(self):
        t0 = time.perf_counter()
        capture_end(self)
        ends.append(time.perf_counter() - t0)
    torch.cuda.CUDAGraph.capture_end = timed_end
    for i in range(args.runs):
        keep = i % 2 == 1
        EpochProgram.count_nodes = keep
        ends.clear()
        r = cs.chunk_run(cfg, dev, "auto")
        e = r["run"].epoch
        inst = ("" if e.instantiate_s is None
                else f", instantiating {e.instantiate_s:.3f} s, "
                     f"{e.nodes} nodes")
        print(f"{args.recipe} run {i} (graph kept: {keep}): capture "
              f"{e.capture_s:.3f} s, of it capture_end {ends[0]:.3f} s"
              f"{inst}; the run {r['wall']:.3f} s, epochs "
              f"{[round(x, 3) for x in r['hist']['epoch_times']]} s",
              flush=True)
    EpochProgram.count_nodes = False


if __name__ == "__main__":
    main()
