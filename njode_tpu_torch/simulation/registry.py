"""Custom process registry: the extension point for user-defined SDEs (port
of ``njode_tpu.simulation.registry``).

The four functions and their rules are the JAX package's, with one
difference: where a JAX function takes a ``key``, the port's takes an
explicit ``torch.Generator``.  A ``paths_fn`` is called as
``paths_fn(n_paths, *, generator, device, **params)`` and an
``obs_values_fn`` as ``obs_values_fn(times, *, generator, **params)``:

    from njode_tpu_torch.simulation import register_process

    def my_paths(n_paths, *, generator, device=None, **params):
        times = ...   # (G,)
        X = ...       # (n_paths, G), or (n_paths, G, d)
        return times, X            # optionally (times, X, extra)

    register_process("my_sde", my_paths, moments_fn=my_moments)

``simulate_batch``, ``create_trajectory_batch``, the data loaders and (with
a ``moments_fn``) the relative loss then accept ``process_type="my_sde"``.
"""

from __future__ import annotations

from typing import Callable, Optional

_PATHS: dict[str, Callable] = {}
_MOMENTS: dict[str, Callable] = {}
_OBS_VALUES: dict[str, Callable] = {}


def register_process(name: str, paths_fn: Callable,
                     moments_fn: Optional[Callable] = None,
                     obs_values_fn: Optional[Callable] = None) -> None:
    """Register a path generator, and optionally analytic moments and an
    exact observation-time sampler.

    paths_fn(n_paths, *, generator, device, **params) -> (grid_times (G,),
        paths (B, G) or (B, G, d)), or (grid_times, paths, extra); extra is
        kept as ``TrajectoryBatch.switch_times``.
    moments_fn(times (B, N), values (B, N, d), num_moments, variance_method,
        **params) -> (moments, moments_before), both (B, N, d, K).  Per-path
        extras, where the caller passes them, arrive as ``switch_times=``:
        accept ``**kwargs`` to ignore them.
    obs_values_fn(times (B, N), *, generator, **params) -> values (B, N) or
        (B, N, d): exact samples at per-row sorted times with ``times[:, 0]
        == 0``.  It declares an exact transition law over any gap and
        enables ``simulate_batch(obs_only=True)``; the params are the
        process kwargs less ``T`` / ``n_steps``, and the observation grid
        uses ``T`` / ``n_steps`` from those kwargs with the defaults 1.0 and
        100, so a ``paths_fn`` with other defaults needs them passed.

    Re-registering a name replaces the whole entry: an omitted
    ``moments_fn`` or ``obs_values_fn`` clears the earlier one.
    """
    _PATHS[name] = paths_fn
    if moments_fn is not None:
        _MOMENTS[name] = moments_fn
    else:
        _MOMENTS.pop(name, None)
    if obs_values_fn is not None:
        _OBS_VALUES[name] = obs_values_fn
    else:
        _OBS_VALUES.pop(name, None)


def get_paths_fn(name: str) -> Optional[Callable]:
    return _PATHS.get(name)


def get_moments_fn(name: str) -> Optional[Callable]:
    return _MOMENTS.get(name)


def get_obs_values_fn(name: str) -> Optional[Callable]:
    return _OBS_VALUES.get(name)


def registered_processes() -> tuple[str, ...]:
    return tuple(_PATHS)
