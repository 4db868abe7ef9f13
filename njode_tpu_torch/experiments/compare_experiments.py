"""Compare relative-loss curves across completed experiments (port of
``experiments/compare_experiments.py``; reference
experiments/compare_experiments.py, with its OU run name fixed: the CLIs
write ``njode_ou``, not ``njode_ornstein_uhlenbeck``).

    python -m njode_tpu_torch.experiments.compare_experiments [flags]

matplotlib is imported only where a figure is drawn.
"""

import argparse
import csv
import glob
import json
from pathlib import Path

EXPERIMENTS = [
    ("njode_black_scholes", "Black-Scholes"),
    ("njode_ou", "Ornstein-Uhlenbeck"),
    ("njode_heston", "Heston"),
    ("njode_hybrid", "Hybrid OU-BS"),
]


def aggregate_sweep(run_dirs, csv_path, png_path):
    """Aggregate a hyperparameter sweep into a results table: each run's
    ``config.json`` + ``history.json`` becomes one CSV row (final train /
    val / relative loss, total walltime) and the PNG shows a hidden_dim x
    n_hidden_layers heatmap when the sweep spans that grid, otherwise a bar
    chart (the reference's array job leaves nothing to collect its runs,
    reference run_array_job.sh:23-47).  Returns the list of row dicts."""
    rows = []
    for d in sorted(run_dirs):
        d = Path(d)
        try:
            with open(d / "config.json") as f:
                config = json.load(f)
            with open(d / "history.json") as f:
                history = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"(skipping {d}: {e})")
            continue
        rl = [x for x in history.get("relative_loss", [])
              if x == x]  # drop NaNs
        rows.append({
            "run": d.name,
            "hidden_dim": config.get("hidden_dim"),
            "n_hidden_layers": config.get("n_hidden_layers"),
            "final_train_loss": (history.get("train_loss") or [None])[-1],
            "final_val_loss": (history.get("val_loss") or [None])[-1],
            "final_relative_loss": rl[-1] if rl else None,
            "walltime_s": round(sum(history.get("epoch_times", [])), 3),
            "n_epochs": len(history.get("train_loss", [])),
        })
    if not rows:
        print("No sweep runs found.")
        return rows

    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"Sweep results CSV: {csv_path}")

    _plot_sweep(rows, png_path)

    header = (f"{'run':24s} {'hidden':>6s} {'layers':>6s} {'train':>10s} "
              f"{'val':>10s} {'rel':>10s} {'wall_s':>8s}")
    print("\n" + header)
    for r in rows:
        print(f"{r['run']:24s} {str(r['hidden_dim']):>6s} "
              f"{str(r['n_hidden_layers']):>6s} "
              f"{_fmt(r['final_train_loss']):>10s} "
              f"{_fmt(r['final_val_loss']):>10s} "
              f"{_fmt(r['final_relative_loss']):>10s} "
              f"{r['walltime_s']:>8.1f}")
    return rows


def _fmt(x):
    return f"{x:.4f}" if isinstance(x, (int, float)) else "-"


def _plot_sweep(rows, png_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    hiddens = sorted({r["hidden_dim"] for r in rows
                      if r["hidden_dim"] is not None})
    layers = sorted({r["n_hidden_layers"] for r in rows
                     if r["n_hidden_layers"] is not None})
    by_key = {(r["hidden_dim"], r["n_hidden_layers"]): r for r in rows}
    full_grid = (len(hiddens) > 1 and len(layers) > 1
                 and all((h, l) in by_key for h in hiddens for l in layers))

    if full_grid:
        def _val(h, l):
            v = by_key[(h, l)]["final_val_loss"]
            return np.nan if v is None else v

        grid = np.array([[_val(h, l) for l in layers] for h in hiddens])
        fig, ax = plt.subplots(figsize=(1.6 * len(layers) + 2,
                                        1.2 * len(hiddens) + 2))
        im = ax.imshow(grid, cmap="viridis_r")
        ax.set_xticks(range(len(layers)), [str(l) for l in layers])
        ax.set_yticks(range(len(hiddens)), [str(h) for h in hiddens])
        ax.set_xlabel("n_hidden_layers")
        ax.set_ylabel("hidden_dim")
        ax.set_title("Final validation loss")
        for i in range(len(hiddens)):
            for j in range(len(layers)):
                ax.text(j, i, f"{grid[i, j]:.3f}", ha="center", va="center",
                        color="white", fontsize=9)
        fig.colorbar(im, ax=ax, shrink=0.8)
    else:
        fig, ax = plt.subplots(figsize=(max(6, 0.8 * len(rows)), 4))
        vals = [float("nan") if r["final_val_loss"] is None
                else r["final_val_loss"] for r in rows]
        ax.bar(range(len(rows)), vals)
        ax.set_xticks(range(len(rows)),
                      [r["run"] for r in rows], rotation=45, ha="right")
        ax.set_ylabel("final val loss")
        ax.set_title("Sweep results")
    fig.tight_layout()
    fig.savefig(png_path, dpi=120)
    plt.close(fig)
    print(f"Sweep results plot: {png_path}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Compare Neural Jump ODE experiments')
    parser.add_argument('--runs-dir', type=str, default='runs',
                        help='Directory containing experiment runs')
    parser.add_argument('--output', type=str,
                        default='runs/comparison_relative_loss.png',
                        help='Output plot path')
    parser.add_argument('--sweep', type=str, default=None,
                        help="Glob of sweep run directories (e.g. "
                             "'runs/sweep_*'): aggregate their configs and "
                             "histories into a CSV + PNG results table "
                             "instead of the relative-loss overlay")
    parser.add_argument('--sweep-csv', type=str, default=None,
                        help='CSV output path for --sweep '
                             '(default: <runs-dir>/sweep_results.csv)')
    parser.add_argument('--sweep-png', type=str, default=None,
                        help='PNG output path for --sweep '
                             '(default: <runs-dir>/sweep_results.png)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    if args.sweep:
        run_dirs = [d for d in glob.glob(args.sweep) if Path(d).is_dir()]
        aggregate_sweep(
            run_dirs,
            args.sweep_csv or str(Path(args.runs_dir) / "sweep_results.csv"),
            args.sweep_png or str(Path(args.runs_dir) / "sweep_results.png"))
        return

    runs = Path(args.runs_dir)
    history_paths, labels = [], []
    for name, label in EXPERIMENTS:
        hp = runs / name / "history.json"
        if hp.exists():
            history_paths.append(str(hp))
            labels.append(label)
        else:
            print(f"(skipping {label}: no {hp})")

    if not history_paths:
        print(f"No completed experiments found under {runs}/")
        return

    from ..utils.plotting import plot_relative_loss
    plot_relative_loss(history_paths, labels, save_path=args.output)
    print(f"Comparison plot saved to {args.output}")

    print("\nFinal relative losses:")
    for hp, label in zip(history_paths, labels):
        with open(hp) as f:
            history = json.load(f)
        rl = history.get("relative_loss", [])
        if rl:
            print(f"  {label:20s} {rl[-1]: .4f}")
        else:
            print(f"  {label:20s} (no relative loss recorded)")


if __name__ == "__main__":
    main()
