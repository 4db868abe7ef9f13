"""Ornstein-Uhlenbeck Neural Jump ODE experiment (port of
``experiments/experiment_ou.py``; reference experiments/experiment_ou.py).

The ``--activation`` default is ``'identity'``, as the reference ships it:
not among the choices, it resolves to ReLU through the activation
registry's fallback (reference experiment_ou.py:30, models/jump_ode.py:18).

    python -m njode_tpu_torch.experiments.experiment_ou [flags]
"""

import argparse

from .common import add_common_args, build_config, run_and_plot

PROCESS, NAME = "ornstein_uhlenbeck", "njode_ou"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Ornstein-Uhlenbeck Neural Jump ODE Experiment')
    add_common_args(parser, activation_default='identity')
    # Process parameters (reference experiment_ou.py:65-70)
    parser.add_argument('--theta', type=float, default=1.0,
                        help='OU mean reversion speed')
    parser.add_argument('--mu', type=float, default=0.5,
                        help='OU long-term mean')
    parser.add_argument('--sigma', type=float, default=0.3,
                        help='OU volatility')
    parser.add_argument('--x0', type=float, default=0.0, help='Initial value')
    return parser.parse_args(argv)


def configure(args):
    """(config, the plot's process parameters) of parsed flags."""
    process_params = {"theta": args.theta, "mu": args.mu, "sigma": args.sigma,
                      "x0": args.x0}
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
