"""Heston stochastic-volatility Neural Jump ODE experiment (port of
``experiments/experiment_heston.py``; reference
experiments/experiment_heston.py).  The input is the price alone: the
variance process is simulated but never observed, as in the reference.

    python -m njode_tpu_torch.experiments.experiment_heston [flags]
"""

import argparse

from .common import add_common_args, build_config, run_and_plot

PROCESS, NAME = "heston", "njode_heston"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Heston Neural Jump ODE Experiment')
    add_common_args(parser)
    # Process parameters (reference experiment_heston.py:65-73)
    parser.add_argument('--mu', type=float, default=0.5,
                        help='Heston drift parameter')
    parser.add_argument('--kappa', type=float, default=2.0,
                        help='Heston mean reversion speed')
    parser.add_argument('--theta', type=float, default=0.04,
                        help='Heston long-term variance')
    parser.add_argument('--xi', type=float, default=0.5,
                        help='Heston volatility of volatility')
    parser.add_argument('--rho', type=float, default=-0.5,
                        help='Heston correlation')
    parser.add_argument('--x0', type=float, default=1.0,
                        help='Initial stock price')
    parser.add_argument('--v0', type=float, default=0.04,
                        help='Initial variance')
    return parser.parse_args(argv)


def configure(args):
    """(config, the plot's process parameters) of parsed flags."""
    process_params = {"mu": args.mu, "kappa": args.kappa, "theta": args.theta,
                      "xi": args.xi, "rho": args.rho, "x0": args.x0,
                      "v0": args.v0}
    config = build_config(args, NAME, PROCESS, process_params)
    return config, {**process_params, "T": args.T, "n_steps": args.n_steps}


def main(argv=None):
    args = parse_args(argv)
    config, plot_params = configure(args)
    return run_and_plot(config, PROCESS, plot_params,
                        make_plots=not args.no_plots,
                        profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
