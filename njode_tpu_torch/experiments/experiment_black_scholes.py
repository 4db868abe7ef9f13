"""Black-Scholes Neural Jump ODE experiment (port of
``experiments/experiment_black_scholes.py``; reference
experiments/experiment_black_scholes.py).

    python -m njode_tpu_torch.experiments.experiment_black_scholes [flags]
"""

import argparse

from .common import add_common_args, build_config, run_and_plot

PROCESS, NAME = "black_scholes", "njode_black_scholes"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Black Scholes Neural Jump ODE Experiment')
    add_common_args(parser)
    # Process parameters (reference experiment_black_scholes.py:65-69)
    parser.add_argument('--mu', type=float, default=0.1,
                        help='Black Scholes drift parameter')
    parser.add_argument('--sigma', type=float, default=0.5,
                        help='Black Scholes volatility parameter')
    parser.add_argument('--x0', type=float, default=1.0, help='Initial value')
    return parser.parse_args(argv)


def configure(args):
    """(config, the plot's process parameters) of parsed flags."""
    process_params = {"mu": args.mu, "sigma": args.sigma, "x0": args.x0}
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
