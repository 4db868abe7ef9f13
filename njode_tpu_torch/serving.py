"""Online serving for trained NJ-ODE models (port of ``njode_tpu.serving``).

:class:`NJODEFilter` holds a compact per-stream state (latest jump latent
and last observation), ``update``s it on each new observation and
``predict``s conditional moments at any later time.  Both are O(1) in stream
length, because the jump resets the latent and no history is needed.  Batch
queries over stored histories are :meth:`NeuralJumpODE.predict_at`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .models import NeuralJumpODE


@dataclass
class FilterState:
    """Per-stream sufficient statistic: (latent after last jump, last obs)."""
    h: torch.Tensor        # (K_h, B, d_h)
    x_last: torch.Tensor   # (B, d_x)
    t_last: torch.Tensor   # (B,)
    seen: torch.Tensor     # (B,) bool: any observation yet?


class NJODEFilter:
    """Streaming conditional-moment filter around a trained model."""

    def __init__(self, model: NeuralJumpODE):
        self.model = model

    def init_state(self, n_streams: int) -> FilterState:
        m = self.model
        kw = dict(dtype=m.dtype, device=m.device)
        return FilterState(
            h=torch.zeros(m.k_hidden, n_streams, m.hidden_dim, **kw),
            x_last=torch.zeros(n_streams, m.input_dim, **kw),
            t_last=torch.zeros(n_streams, **kw),
            seen=torch.zeros(n_streams, dtype=torch.bool, device=m.device),
        )

    def update(self, state: FilterState, t_obs, x_obs,
               obs_mask: Optional[torch.Tensor] = None) -> FilterState:
        """Ingest one observation per stream (mask=False streams hold)."""
        m = self.model
        with m._inference():
            t_obs = m._as_tensor(t_obs).expand(state.t_last.shape).contiguous()
            x_obs = m._as_tensor(x_obs)
            h_new = m._jump(x_obs)
            if obs_mask is None:
                return FilterState(h_new, x_obs, t_obs,
                                   torch.ones_like(state.seen))
            mk = m._as_tensor(obs_mask, torch.bool)
            return FilterState(
                torch.where(mk[None, :, None], h_new, state.h),
                torch.where(mk[:, None], x_obs, state.x_last),
                torch.where(mk, t_obs, state.t_last),
                state.seen | mk,
            )

    def predict(self, state: FilterState, t_query):
        """Conditional moments at ``t_query`` (>= each stream's t_last)."""
        m = self.model
        with m._inference():
            t_query = m._as_tensor(t_query).expand(state.t_last.shape)
            # with fixed dt_ode_step, gaps beyond the substep budget would
            # silently under-integrate
            m._check_gap_budget(torch.clamp_min(t_query - state.t_last, 0.0))
            h = m._integrate_gap(state.h, state.x_last, state.t_last, t_query)
            y = m._readout(h)                              # (B, d_y, K)
            y = torch.where(state.seen[:, None, None], y, 0.0)
            return {"mean": y[..., 0], "var": m.variance_from_raw(y),
                    "raw": y}
