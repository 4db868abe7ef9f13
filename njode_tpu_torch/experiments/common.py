"""Shared experiment-CLI plumbing of the port (``experiments/common.py`` of
the JAX package, which the port does not import).

The flag surface is the JAX CLIs' flag for flag, with the same defaults and
choices, so :func:`build_config` returns the same config dict for every
argv; the help strings describe the port's routes.  Flags whose path is not
ported (``--ensemble``, ``--ensemble-lrs``, ``--data-parallel``,
``--model-parallel``, ``--multihost``, ``--checkpoint-backend orbax``) parse
as there, and ``run_experiment`` refuses them.  Each experiment module
declares its own process flags and runs ``python -m
njode_tpu_torch.experiments.experiment_<name>``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..models import NeuralJumpODE
from ..models.jump_ode import resolve_device
from ..simulation import supports_obs_only
from ..utils import load_checkpoint, run_experiment
from ..utils.profiling import maybe_trace


def add_common_args(parser: argparse.ArgumentParser,
                    activation_default: str = "relu") -> None:
    """Architecture/training/moment/data flags shared by every experiment
    (reference experiments/experiment_black_scholes.py:23-64)."""
    # Model architecture
    parser.add_argument('--hidden-dim', type=int, default=32,
                        help='Width of the latent state h and of every MLP '
                             'hidden layer')
    parser.add_argument('--n-hidden-layers', type=int, default=1,
                        help='Hidden-layer count in each of the three MLPs')
    parser.add_argument('--activation', type=str, default=activation_default,
                        choices=['relu', 'tanh', 'sigmoid', 'elu',
                                 'leaky_relu', 'selu'],
                        help='Nonlinearity used throughout the networks')
    parser.add_argument('--dropout-rate', type=float, default=0.0,
                        help='Train-time dropout probability (0 disables)')
    parser.add_argument('--input-scaling', type=str, default='identity',
                        choices=['identity', 'tanh', 'sigmoid'],
                        help='Squashing applied to (h, x) before the drift '
                             'MLP sees them')
    parser.add_argument('--variance-method', type=str, default='direct',
                        choices=['direct', 'second_moment'],
                        help='How moment 1 parameterizes the variance: '
                             'direct squares the raw head output W; '
                             'second_moment regresses E[X^2] and derives '
                             'Var = E[X^2] - mean^2')
    parser.add_argument('--dt-ode-step', type=float, default=None,
                        help='Euler substep size inside each inter-'
                             'observation gap; omit to take one step per gap')

    # Training parameters
    parser.add_argument('--learning-rate', type=float, default=1e-3,
                        help='Adam step size')
    parser.add_argument('--weight-decay', type=float, default=5e-4,
                        help='L2 penalty folded into the gradient '
                             '(torch-Adam style, not decoupled)')
    parser.add_argument('--n-epochs', type=int, default=200,
                        help='Total training epochs')
    parser.add_argument('--batch-size', type=int, default=128,
                        help='Trajectories per minibatch')
    parser.add_argument('--no-shuffle', action='store_true',
                        help='Keep trajectory order fixed across minibatches '
                             'instead of reshuffling each epoch')
    parser.add_argument('--print-every', type=int, default=5,
                        help='Epoch interval for progress lines, relative-'
                             'loss evals and checkpoint saves')
    parser.add_argument('--device', type=str, default='auto',
                        help='Device to run on: auto (= cuda; raises '
                             'without a CUDA card), cpu, or a CUDA device '
                             'such as cuda:1')

    # Moment learning
    parser.add_argument('--num-moments', type=int, default=2,
                        help='How many conditional moments the model predicts')
    parser.add_argument('--moment-weights', type=float, nargs='+',
                        default=[1.0, 10.0],
                        help='Per-moment coefficients in the training loss')
    parser.add_argument('--shared-network', action='store_true',
                        help='One wide network emitting all moments at once '
                             'instead of a separate network per moment')
    parser.add_argument('--extended-moments', action='store_true',
                        help='Train moments >= 2 against their analytic '
                             'targets (extension: the reference allocates '
                             'but never trains higher-moment networks)')

    # Data parameters
    parser.add_argument('--cache-data', action='store_true',
                        help='Simulate one training set up front and reuse '
                             'it every epoch; by default each epoch draws '
                             'new paths')
    parser.add_argument('--n-train', type=int, default=1000,
                        help='Training-set trajectory count')
    parser.add_argument('--n-val', type=int, default=200,
                        help='Validation-set trajectory count')
    parser.add_argument('--obs-fraction', type=float, default=0.1,
                        help='Share of grid points revealed as observations')
    parser.add_argument('--T', type=float, default=1.0,
                        help='Simulation end time')
    parser.add_argument('--n-steps', type=int, default=100,
                        help='Grid resolution: simulation steps over [0, T]')

    # scale-out and ensembles: parsed as in the JAX package, refused by
    # run_experiment until they are ported (ROADMAP.md, Queue 1 items 11-12)
    parser.add_argument('--data-parallel', type=int, default=0,
                        help='Shard trajectories over N devices (0 = single '
                             'device); not ported: N > 1 raises')
    parser.add_argument('--model-parallel', type=int, default=1,
                        help='Size of the mesh\'s model axis; not ported: '
                             'N > 1 raises')
    parser.add_argument('--model-parallel-mode', type=str, default=None,
                        choices=['moments', 'hidden'],
                        help='What the model axis shards (default: moments '
                             'when --model-parallel > 1); not ported')
    parser.add_argument('--multihost', action='store_true',
                        help='Train over several hosts; not ported: raises')
    parser.add_argument('--coordinator-address', type=str, default=None,
                        help='host:port of process 0 for --multihost')
    parser.add_argument('--num-processes', type=int, default=None,
                        help='Total process count for --multihost')
    parser.add_argument('--process-id', type=int, default=None,
                        help='This process\'s rank for --multihost')
    parser.add_argument('--seed', type=int, default=0,
                        help='Model-init / shuffle seed')
    parser.add_argument('--data-seed', type=int, default=0,
                        help='Data-generation seed')
    parser.add_argument('--ensemble', type=int, default=0,
                        help='Train K independently-seeded models (0/1 = '
                             'single model); not ported: K > 1 raises')
    parser.add_argument('--ensemble-lrs', type=str, default=None,
                        help='Comma-separated per-member learning rates '
                             '(population training); implies --ensemble '
                             'len(lrs) when --ensemble is unset, otherwise '
                             'the lengths must match; not ported: raises')
    parser.add_argument('--obs-only', type=str, default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Sample values exactly at the observation times '
                             'instead of simulating the whole grid (same '
                             'data law, fewer random draws). auto (default) '
                             '= on for processes with exact transition laws, '
                             'off otherwise')
    parser.add_argument('--grid-walk', type=str, default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Integrate all --dt-ode-step gaps with one '
                             'time-major walk over the integration grid '
                             '(requires every observation time to be a '
                             'multiple of --dt-ode-step; agrees with the '
                             'per-gap loops to float32 roundoff). auto '
                             '(default) = on exactly where a CUDA kernel '
                             'carries the walk: on a CUDA device, --kernels '
                             'auto, train or force, a walk-kernel-eligible '
                             'config and a grid-aligned T/n-steps; on '
                             'the CPU auto is off. No effect without '
                             '--dt-ode-step')
    parser.add_argument('--ode-solver', type=str, default='euler',
                        choices=['euler', 'heun', 'rk4'],
                        help='Latent-ODE integrator (euler = reference '
                             'semantics; heun/rk4 = higher-order accuracy '
                             'per substep)')
    parser.add_argument('--compute-dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='Dtype of the networks\' products (parameters '
                             'stay float32); with --kernels step bfloat16 '
                             'runs the fused step\'s bf16 tensor-core '
                             'kernels')
    parser.add_argument('--checkpoint-backend', type=str, default='msgpack',
                        choices=['msgpack', 'orbax'],
                        help='Checkpoint format: msgpack = the port\'s one '
                             'torch.save file (model.ckpt); orbax is not '
                             'ported and raises')
    parser.add_argument('--kernels', type=str, default='auto',
                        choices=['off', 'auto', 'force', 'step', 'train'],
                        help='CUDA kernel policy. auto (default): the '
                             'gap kernel for inference gaps, the whole-run '
                             'training kernel where the model is eligible '
                             '(separate networks, one hidden layer, '
                             'hidden <= 128, no --dt-ode-step) or its '
                             'walk-train twin (shared network, '
                             '--dt-ode-step, grid-aligned data), the walk '
                             'kernels where the grid walk runs, and the '
                             'fused-step kernels only at the shape an H100 '
                             'A/B measured ahead (AUTO_SHAPE_H100: hidden '
                             '256, two separate networks, >= 4,096 rows a '
                             'step); off = no kernel but the gap kernel for '
                             'inference; force = the per-gap kernels: the '
                             'gap loop\'s training pair and the fused Euler '
                             'cell; step = the fused whole-step kernels '
                             '(separate networks, one hidden layer, no '
                             'dropout, no --dt-ode-step); train = the '
                             'whole-run kernel or its walk twin, raising '
                             'where neither applies. CUDA tensors only: on '
                             'the CPU each kernel\'s plain PyTorch version '
                             'runs')
    parser.add_argument('--train-kernel-mxu', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='Operand precision of the products inside the '
                             'whole-run training kernels (accumulation '
                             'stays float32): bfloat16 takes their bf16 '
                             'instances; ignored on the other paths')
    parser.add_argument('--debug-checks', action='store_true',
                        help='Enable runtime checks (substep-budget '
                             'exhaustion, grid alignment); each costs a '
                             'host read')
    parser.add_argument('--profile-dir', type=str, default=None,
                        help='Write a torch.profiler Chrome trace of the '
                             'run here (with the card\'s activity on CUDA)')
    parser.add_argument('--no-plots', action='store_true',
                        help='Skip plot generation after training (plots '
                             'need matplotlib)')
    parser.add_argument('--experiment-name', type=str, default=None,
                        help='Override the run directory name under runs/ '
                             '(lets sweep configs run concurrently without '
                             'colliding)')


def _resolve_obs_only(choice: str, process_type: str) -> bool:
    """'auto' -> exact observation-time sampling where a transition law
    exists; 'on' requires one (simulate_batch raises otherwise)."""
    if choice == "on":
        return True
    if choice == "auto":
        return supports_obs_only(process_type)
    return False


def _parse_ensemble_lrs(args):
    """--ensemble-lrs 'a,b,c' -> [a, b, c]; implies --ensemble len(lrs)
    when unset, must match it otherwise."""
    raw = getattr(args, "ensemble_lrs", None)
    if not raw:
        return None
    try:
        lrs = [float(x) for x in raw.split(",") if x.strip()]
    except ValueError:
        raise SystemExit(f"--ensemble-lrs: could not parse {raw!r} as "
                         "comma-separated floats")
    if len(lrs) < 2:
        raise SystemExit("--ensemble-lrs needs at least 2 values (a single "
                         "lr is just --learning-rate)")
    if args.ensemble and args.ensemble != len(lrs):
        raise SystemExit(f"--ensemble {args.ensemble} does not match the "
                         f"{len(lrs)} values of --ensemble-lrs")
    args.ensemble = len(lrs)
    return lrs


def build_config(args, experiment_name: str, process_type: str,
                 data_params: dict) -> dict:
    """Assemble the nested config dict (reference experiment_*.py:79-113)."""
    ensemble_lrs = _parse_ensemble_lrs(args)       # may set args.ensemble
    return {
        "experiment_name": getattr(args, "experiment_name", None)
                           or experiment_name,
        "input_dim": 1,
        "hidden_dim": args.hidden_dim,
        "output_dim": 1,
        "n_hidden_layers": args.n_hidden_layers,
        "activation": args.activation,
        "dropout_rate": args.dropout_rate,
        "input_scaling": args.input_scaling,
        "variance_method": args.variance_method,
        "dt_ode_step": args.dt_ode_step,
        "ode_solver": args.ode_solver,
        "learning_rate": args.learning_rate,
        "weight_decay": args.weight_decay,
        "n_epochs": args.n_epochs,
        "batch_size": args.batch_size,
        "shuffle": not args.no_shuffle,
        "print_every": args.print_every,
        "device": args.device,
        "ignore_first_continuity": True,
        "num_moments": args.num_moments,
        "moment_weights": args.moment_weights,
        "shared_network": args.shared_network,
        "extended_moments": args.extended_moments,
        "data_parallel": args.data_parallel,
        "model_parallel": args.model_parallel,
        "model_parallel_mode": args.model_parallel_mode,
        "multihost": args.multihost,
        "coordinator_address": args.coordinator_address,
        "num_processes": args.num_processes,
        "process_id": args.process_id,
        "compute_dtype": args.compute_dtype,
        "checkpoint_backend": args.checkpoint_backend,
        "ensemble": args.ensemble,
        "ensemble_lrs": ensemble_lrs,
        "use_pallas": {"off": False, "auto": "auto", "force": True,
                       "step": "step", "train": "train"}[args.kernels],
        "grid_walk": args.grid_walk,
        "train_kernel_mxu": args.train_kernel_mxu,
        "debug_checks": args.debug_checks,
        "seed": args.seed,
        "data_seed": args.data_seed,
        "data": {
            "process_type": process_type,
            "n_train": args.n_train,
            "n_val": args.n_val,
            "obs_fraction": args.obs_fraction,
            "cache_data": args.cache_data,
            "obs_only": _resolve_obs_only(args.obs_only, process_type),
            "T": args.T,
            "n_steps": args.n_steps,
            **data_params,
        },
    }


def run_and_plot(config: dict, process_type: str, process_params: dict,
                 make_plots: bool = True, save_dir: str = "runs",
                 profile_dir: str = None):
    """run_experiment (traced into ``profile_dir`` when given) + the three
    standard plots (reference experiment_*.py main bodies).  Plots need
    matplotlib: without it the ImportError propagates."""
    device = resolve_device(config.get("device", "auto"))
    with maybe_trace(profile_dir, cuda=device.type == "cuda"):
        results = run_experiment(config, save_dir=save_dir)

    save_path = Path(results["save_path"])
    if make_plots:
        from ..utils.plotting import (
            plot_relative_loss_single, plot_single_trajectory_with_condexp,
            plot_training_history)

        print("\nGenerating training history plot...")
        plot_training_history(str(save_path / "history.json"),
                              str(save_path / "training_history.png"))

        print("Generating relative loss plot...")
        try:
            plot_relative_loss_single(str(save_path / "history.json"),
                                      str(save_path / "relative_loss.png"))
        except Exception as e:
            print(f"Could not plot relative loss: {e}")

        print("Generating trajectory comparison plot...")
        # the JAX package's plot model: the run's architecture, the kernel
        # policy left at its default
        model = NeuralJumpODE(
            input_dim=config["input_dim"], hidden_dim=config["hidden_dim"],
            output_dim=config["output_dim"],
            dt_ode_step=config.get("dt_ode_step"),
            num_moments=config.get("num_moments", 1),
            n_hidden_layers=config.get("n_hidden_layers", 1),
            activation=config.get("activation", "relu"),
            shared_network=config.get("shared_network", False),
            dropout_rate=config.get("dropout_rate", 0.0),
            input_scaling=config.get("input_scaling", "identity"),
            variance_method=config.get("variance_method", "direct"),
            t_max=config["data"].get("T", 1.0),
            ode_solver=config.get("ode_solver", "euler"),
            compute_dtype=config.get("compute_dtype"), device=device)
        state_dict, _, _ = load_checkpoint(str(save_path / "model.ckpt"),
                                           map_location=device)
        model.load_state_dict(state_dict)
        plot_single_trajectory_with_condexp(
            model=model, process_type=process_type,
            process_params=process_params,
            obs_fraction=config["data"]["obs_fraction"], seed=42,
            save_path=str(save_path / "trajectory_comparison.png"))

    print("\nExperiment completed successfully!")
    print(f"Results saved in: {save_path}")
    print(f"Final training loss: {results['final_train_loss']:.6f}")
    if results["final_val_loss"]:
        print(f"Final validation loss: {results['final_val_loss']:.6f}")
    return results
