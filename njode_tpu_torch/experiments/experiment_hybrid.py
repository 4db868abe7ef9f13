"""Hybrid OU->Black-Scholes regime-switching experiment (port of
``experiments/experiment_hybrid.py``; reference
experiments/experiment_hybrid.py).  ``--switch-time`` omitted means a random
per-path switch time Uniform(0.2T, 0.8T).

    python -m njode_tpu_torch.experiments.experiment_hybrid [flags]
"""

import argparse

from .common import add_common_args, build_config, run_and_plot

PROCESS, NAME = "hybrid_ou_bs", "njode_hybrid"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Hybrid OU-BS Neural Jump ODE Experiment')
    add_common_args(parser)
    # Process parameters (reference experiment_hybrid.py:66-80)
    parser.add_argument('--theta-ou', type=float, default=1.0,
                        help='OU mean reversion speed')
    parser.add_argument('--mu-ou', type=float, default=0.5,
                        help='OU long-term mean')
    parser.add_argument('--sigma-ou', type=float, default=0.3,
                        help='OU volatility')
    parser.add_argument('--mu-bs', type=float, default=0.1,
                        help='Black-Scholes drift')
    parser.add_argument('--sigma-bs', type=float, default=0.2,
                        help='Black-Scholes volatility')
    parser.add_argument('--switch-time', type=float, default=None,
                        help='Regime switch time (None = random per path in '
                             '[0.2T, 0.8T])')
    parser.add_argument('--x0', type=float, default=1.0, help='Initial value')
    parser.add_argument('--exact-hybrid-truths', action='store_true',
                        help='Use recorded per-path switch times for the '
                             'relative-loss ground truth (improvement over '
                             'the reference, which disables the metric for '
                             'random switch times)')
    return parser.parse_args(argv)


def configure(args):
    """(config, the plot's process parameters) of parsed flags."""
    process_params = {"theta_ou": args.theta_ou, "mu_ou": args.mu_ou,
                      "sigma_ou": args.sigma_ou, "mu_bs": args.mu_bs,
                      "sigma_bs": args.sigma_bs,
                      "switch_time": args.switch_time, "x0": args.x0}
    config = build_config(args, NAME, PROCESS, process_params)
    config["exact_hybrid_truths"] = args.exact_hybrid_truths
    return config, {**process_params, "T": args.T, "n_steps": args.n_steps}


def main(argv=None):
    args = parse_args(argv)
    config, plot_params = configure(args)
    return run_and_plot(config, PROCESS, plot_params,
                        make_plots=not args.no_plots,
                        profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
