"""Val MSE and epoch times of the rk4 production recipe
(``scripts/run_production_rk4_torch.sh``: the composed per-gap rk4 loop, no
kernel) beside the Euler production recipe
(``scripts/run_black_scholes_torch.sh``: the walk-train kernel) on one CUDA
card, over seeds; with ``--full``, one whole run of the rk4 twin.

    PYTHONPATH=. python scripts/measure_torch_rk4_recipe.py \\
        [--seeds 0 1 2] [--epochs 20] [--full] [--out DIR]

Each (recipe, seed) is ``run_experiment`` of the recipe's CLI config with
``--seed s --data-seed s``, cut to ``--epochs`` epochs.  Its model, loaded
from the checkpoint, is scored on 2,000 fresh Black-Scholes paths of one
fixed generator (seed 7, the same for every run): the MSE of the
before-jump mean and variance against the closed forms from slot 1 on
(``njode_tpu_torch.utils.conditional_moment_mse``).  ``--full`` runs the
rk4 twin's shell script itself (200 epochs, ``--no-plots``, seed 0) and
scores its checkpoint the same way.  Prints the card's name and power limit,
one line a run, and writes ``DIR/rk4_recipe.json`` (default
``chiprun_out``).  Without a CUDA card it fails.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the recipes' CLI configs)
from njode_tpu_torch import NeuralJumpODE  # noqa: E402
from njode_tpu_torch.simulation import simulate_batch  # noqa: E402
from njode_tpu_torch.utils import (conditional_moment_mse,  # noqa: E402
                                   load_checkpoint, run_experiment)

RECIPES = {"rk4": "production-rk4", "euler": "production"}
BS_PARAMS = dict(mu=0.1, sigma=0.5, x0=1.0)
N_SCORE, SCORE_SEED = 2_000, 7


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def scored(config: dict, ckpt: Path, dev: torch.device) -> dict:
    """The val MSE of a run's checkpoint on the fixed scoring paths."""
    model = NeuralJumpODE(
        1, config["hidden_dim"], 1, num_moments=config["num_moments"],
        shared_network=config["shared_network"],
        dt_ode_step=config["dt_ode_step"],
        ode_solver=config.get("ode_solver", "euler"), device=dev)
    sd, _, _ = load_checkpoint(str(ckpt), map_location=dev)
    model.load_state_dict(sd)
    gen = torch.Generator(device=dev).manual_seed(SCORE_SEED)
    batch = simulate_batch(N_SCORE, "black_scholes",
                           config["data"]["obs_fraction"], generator=gen,
                           device=dev, **BS_PARAMS)
    return conditional_moment_mse(model, batch, "black_scholes",
                                  **BS_PARAMS)


def seeded_run(recipe: str, seed: int, epochs: int, tmp: Path,
               dev: torch.device) -> dict:
    cfg = chip_smoke.recipe_config(RECIPES[recipe], epochs,
                                   f"{recipe}_s{seed}", "--seed", str(seed),
                                   "--data-seed", str(seed),
                                   "--print-every", str(epochs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_experiment(cfg, save_dir=str(tmp))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mse = scored(cfg, Path(res["save_path"]) / "model.ckpt", dev)
    ep = res["history"]["epoch_times"]
    return {"recipe": recipe, "seed": seed, "epochs": epochs, "wall_s": wall,
            "epoch_s_median": statistics.median(ep[1:] or ep),
            "epoch_s_first": ep[0], "val_mse_mean": mse["mean"],
            "val_mse_var": mse["var"],
            "final_val_loss": res["final_val_loss"]}


def full_run(dev: torch.device) -> dict:
    """The rk4 twin itself, 200 epochs at seed 0, --no-plots."""
    name = f"rk4_full_{int(time.time())}"
    t0 = time.perf_counter()
    subprocess.run(["bash", str(REPO / "scripts/run_production_rk4_torch.sh"),
                    "--no-plots", "--experiment-name", name,
                    "--print-every", "20"], cwd=REPO, check=True)
    wall = time.perf_counter() - t0
    run = REPO / "runs" / name
    cfg = json.loads((run / "config.json").read_text())
    hist = json.loads((run / "history.json").read_text())
    mse = scored(cfg, run / "model.ckpt", dev)
    ep = hist["epoch_times"]
    return {"recipe": "rk4 twin", "seed": 0, "epochs": len(ep),
            "wall_s": wall, "epoch_s_median": statistics.median(ep),
            "epoch_s_first": ep[0], "val_mse_mean": mse["mean"],
            "val_mse_var": mse["var"], "final_val_loss": hist["val_loss"][-1]}


def line(r: dict) -> str:
    return (f"{r['recipe']} seed {r['seed']}, {r['epochs']} epochs: "
            f"{r['wall_s']:.2f} s of wall, an epoch {r['epoch_s_median']:.4f} "
            f"s (median; the first {r['epoch_s_first']:.4f}), val MSE mean "
            f"{r['val_mse_mean']:.4e} var {r['val_mse_var']:.4e}, final val "
            f"loss {r['final_val_loss']:.5f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="also the rk4 twin's 200-epoch run at seed 0")
    ap.add_argument("--out", default=str(REPO / "chiprun_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            for recipe in RECIPES:
                runs.append(seeded_run(recipe, seed, args.epochs, Path(tmp),
                                       dev))
                print(line(runs[-1]), flush=True)
    for recipe in RECIPES:
        rs = [r for r in runs if r["recipe"] == recipe]
        print(f"{recipe}, {len(rs)} seeds x {args.epochs} epochs: val MSE "
              f"mean {statistics.median(r['val_mse_mean'] for r in rs):.4e} "
              f"(median; {min(r['val_mse_mean'] for r in rs):.4e}-"
              f"{max(r['val_mse_mean'] for r in rs):.4e}), var "
              f"{statistics.median(r['val_mse_var'] for r in rs):.4e} "
              f"({min(r['val_mse_var'] for r in rs):.4e}-"
              f"{max(r['val_mse_var'] for r in rs):.4e}), an epoch "
              f"{statistics.median(r['epoch_s_median'] for r in rs):.4f} s",
              flush=True)
    if args.full:
        runs.append(full_run(dev))
        print(line(runs[-1]), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "rk4_recipe.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
