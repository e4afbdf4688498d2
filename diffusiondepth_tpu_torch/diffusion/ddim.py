"""DDIM scheduler (port of ``diffusiondepth_tpu/diffusion/ddim.py``).

Tables are built once in float32 numpy and moved to the device once; the
sampling loop indexes them on the device, so no step waits for the host.
All scheduler math stays float32: ``1 - alpha_prod`` underflows in bf16 near
t=0 and poisons the epsilon re-derivation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.native import to_device


def make_betas(
    beta_schedule: str = "linear",
    num_train_timesteps: int = 1000,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
    max_beta: float = 0.999,
) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                        dtype=np.float32) ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = [
            min(1 - alpha_bar((i + 1) / num_train_timesteps)
                / alpha_bar(i / num_train_timesteps), max_beta)
            for i in range(num_train_timesteps)
        ]
        return np.asarray(betas, dtype=np.float32)
    raise NotImplementedError(beta_schedule)


class InferenceTables(NamedTuple):
    """Per-step constants of the reverse process (numpy, float32)."""

    timesteps: np.ndarray  # (N,) int64, descending
    alpha_prod_t: np.ndarray  # (N,) float32
    alpha_prod_prev: np.ndarray  # (N,) float32

    def sched(self) -> np.ndarray:
        """(N, 4) float32 rows [sqrt(a_t), sqrt(1-a_t), sqrt(a_prev),
        sqrt(1-a_prev)], the four scalars of the DDIM-step kernel."""
        a_t = self.alpha_prod_t
        a_p = self.alpha_prod_prev
        return np.stack(
            [np.sqrt(a_t), np.sqrt(np.float32(1.0) - a_t),
             np.sqrt(a_p), np.sqrt(np.float32(1.0) - a_p)], axis=1
        ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    clip_sample: bool = False
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"
    betas: np.ndarray = dataclasses.field(default=None, repr=False)
    alphas_cumprod: np.ndarray = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.betas is None:
            object.__setattr__(self, "betas", make_betas(
                self.beta_schedule, self.num_train_timesteps,
                self.beta_start, self.beta_end))
        if self.alphas_cumprod is None:
            object.__setattr__(
                self, "alphas_cumprod",
                np.cumprod(1.0 - self.betas, axis=0).astype(np.float32))

    @property
    def final_alpha_cumprod(self) -> float:
        return 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        step_ratio = self.num_train_timesteps // num_inference_steps
        t = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return t + self.steps_offset

    SI_TIMESTEPS_20 = (999, 500, 250, 125, 80, 50, 35, 20, 15, 12,
                       9, 8, 7, 6, 5, 4, 3, 2, 1, 0)

    def biased_timesteps(self, num_inference_steps: int) -> np.ndarray:
        if num_inference_steps == len(self.SI_TIMESTEPS_20):
            return np.asarray(self.SI_TIMESTEPS_20, np.int64) + self.steps_offset
        x = np.linspace(0.0, 1.0, num_inference_steps)
        t = np.exp(np.log(float(self.num_train_timesteps)) * x) - 1.0
        t = np.clip(np.round(t), 0, self.num_train_timesteps - 1).astype(np.int64)
        t = np.unique(t)
        while len(t) < num_inference_steps:
            candidates = np.setdiff1d(np.arange(self.num_train_timesteps), t)
            t = np.sort(np.append(t, candidates[-1]))
        return t[::-1].copy() + self.steps_offset

    def inference_tables(
        self, num_inference_steps: int, timesteps: Optional[np.ndarray] = None
    ) -> InferenceTables:
        """prev(t) is the next entry of the descending sequence; the last
        step goes to ``final_alpha_cumprod``."""
        if timesteps is None:
            timesteps = self.inference_timesteps(num_inference_steps)
        timesteps = np.asarray(timesteps, np.int64)
        prev_timesteps = np.append(timesteps[1:], -1)
        alpha_t = self.alphas_cumprod[timesteps].astype(np.float32)
        alpha_prev = np.where(
            prev_timesteps >= 0,
            self.alphas_cumprod[np.clip(prev_timesteps, 0, None)],
            self.final_alpha_cumprod,
        ).astype(np.float32)
        return InferenceTables(timesteps, alpha_t, alpha_prev)

    def _sqrt_alphas(self, timesteps: torch.Tensor, like: torch.Tensor):
        acp = to_device(self.alphas_cumprod, like.device, like.dtype)
        a = acp[timesteps.to(like.device)]
        a = a.reshape(a.shape + (1,) * (like.ndim - a.ndim))
        return torch.sqrt(a), torch.sqrt(1.0 - a)

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(a_t) x_0 + sqrt(1 - a_t) noise, per-sample t."""
        sa, sb = self._sqrt_alphas(timesteps, original_samples)
        return sa * original_samples + sb * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target sqrt(a_t) noise - sqrt(1 - a_t) sample."""
        sa, sb = self._sqrt_alphas(timesteps, sample)
        return sa * noise - sb * sample

    def step_from_alphas(
        self,
        model_output: torch.Tensor,
        sample: torch.Tensor,
        alpha_prod_t,
        alpha_prod_prev,
        eta: float = 0.0,
        use_clipped_model_output: bool = True,
        variance_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One DDIM reverse step; returns ``(prev_sample, pred_original)``.
        The alphas may be Python floats or 0-d tensors on the device."""
        alpha_prod_t = to_device(alpha_prod_t, sample.device, sample.dtype)
        alpha_prod_prev = to_device(alpha_prod_prev, sample.device, sample.dtype)
        beta_prod_t = 1.0 - alpha_prod_t
        sqrt_alpha_t = torch.sqrt(alpha_prod_t)
        sqrt_beta_t = torch.sqrt(beta_prod_t)

        if self.prediction_type == "epsilon":
            pred_original = (sample - sqrt_beta_t * model_output) / sqrt_alpha_t
        elif self.prediction_type == "sample":
            pred_original = model_output
        elif self.prediction_type == "v_prediction":
            pred_original = sqrt_alpha_t * sample - sqrt_beta_t * model_output
            model_output = sqrt_alpha_t * model_output + sqrt_beta_t * sample
        else:
            raise ValueError(self.prediction_type)

        if self.clip_sample:
            pred_original = torch.clamp(pred_original, -1.0, 1.0)

        variance = (1.0 - alpha_prod_prev) / beta_prod_t * (
            1.0 - alpha_prod_t / alpha_prod_prev)
        std_dev_t = eta * torch.sqrt(variance)

        if use_clipped_model_output:
            model_output = (sample - sqrt_alpha_t * pred_original) / sqrt_beta_t

        pred_dir = torch.sqrt(1.0 - alpha_prod_prev - std_dev_t ** 2) * model_output
        prev_sample = torch.sqrt(alpha_prod_prev) * pred_original + pred_dir

        if eta > 0:
            if variance_noise is None:
                raise ValueError("eta > 0 requires variance_noise")
            prev_sample = prev_sample + std_dev_t * variance_noise
        return prev_sample, pred_original

    def step(
        self,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        num_inference_steps: int,
        eta: float = 0.0,
        use_clipped_model_output: bool = True,
        variance_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The timestep-indexed (diffusers-style) step: the alphas of
        ``timestep`` and of ``timestep - num_train_timesteps //
        num_inference_steps`` (``final_alpha_cumprod`` below 0)."""
        acp = to_device(self.alphas_cumprod, sample.device)
        t = to_device(timestep, sample.device)
        prev_t = t - self.num_train_timesteps // num_inference_steps
        alpha_prev = torch.where(prev_t >= 0, acp[prev_t.clamp_min(0)],
                                 to_device(self.final_alpha_cumprod, acp.device, acp.dtype))
        return self.step_from_alphas(model_output, sample, acp[t], alpha_prev, eta,
                                     use_clipped_model_output, variance_noise)

    def sample(
        self,
        denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        generator: Optional[torch.Generator],
        shape: Tuple[int, ...],
        num_inference_steps: int,
        dtype: torch.dtype = torch.float32,
        eta: float = 0.0,
        use_clipped_model_output: bool = True,
        return_trajectory: bool = False,
        timesteps: Optional[np.ndarray] = None,
        latent: Optional[torch.Tensor] = None,
    ):
        """The whole reverse process: ``denoise_fn(latent, t)`` (t a 0-d
        int64 tensor on the latent's device) predicts the model output at
        each step of ``inference_tables``; the starting latent, and with
        ``eta > 0`` each step's variance noise, are drawn from
        ``generator`` on its device (the CPU's default generator when
        None). ``latent`` hands in the starting latent instead. Returns the
        final latent, and with ``return_trajectory`` also every step's
        latent stacked (steps, *shape)."""
        tables = self.inference_tables(num_inference_steps, timesteps)
        if latent is None:
            latent = torch.randn(shape, generator=generator, dtype=dtype,
                                 device=generator.device if generator is not None else "cpu")
        x = latent.to(dtype)
        ts = to_device(tables.timesteps, x.device)
        a_t = to_device(tables.alpha_prod_t, x.device, x.dtype)
        a_prev = to_device(tables.alpha_prod_prev, x.device, x.dtype)
        traj = []
        for i in range(len(tables.timesteps)):
            vnoise = (torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
                      if eta > 0 else None)
            x, _ = self.step_from_alphas(denoise_fn(x, ts[i]), x, a_t[i], a_prev[i], eta,
                                         use_clipped_model_output, vnoise)
            if return_trajectory:
                traj.append(x)
        if return_trajectory:
            return x, torch.stack(traj)
        return x
