"""Configuration: every field of ``diffusiondepth_tpu.config.Config`` with
the same names and defaults, and the same argparse front end (the
reference CLI's flags and the JAX package's extensions), so that one set of
flags and one ``args.json`` describe a run in both packages. The port keeps
its own copy: it imports nothing of the JAX package.

Two differences: ``compute_dtype`` is a torch dtype, and ``finalize``
raises for a ``mesh_shape`` with a 'model' axis of more than one device
(tensor parallelism is not ported; a 'data' axis is checked against the
devices by ``parallel.create_mesh``, as JAX checks it). The module has no
side effects: build configs with ``Config()``,
``parse_args(argv)`` or ``Config.from_dict(...)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

MODEL_CHOICES = ("NLSPN", "Diffusion_DCbase_", "Diffusion_DCx4base_")
BACKBONE_MODULE_CHOICES = ("mmbev_resnet", "swin", "mpvit")
BACKBONE_NAME_CHOICES = (
    "mmbev_res18",
    "mmbev_res50",
    "mmbev_res101",
    "swin_large_naive_nopretrain",
    "swin_large_naive_l4w722422k",
    "swin_large_naive_swinlargepreatrain_add",
    "mpvit_small",
    # extras of the JAX package: small Swins, and the MPViT variants whose
    # constructors the reference ships without listing them as choices
    "swin_tiny",
    "swin_micro",
    "mpvit_tiny",
    "mpvit_xsmall",
    "mpvit_base",
)
HEAD_CHOICES = (
    "DDIMDepthEstimate_Res",
    "DDIMDepthEstimate_Swin_ADD",
    "DDIMDepthEstimate_Swin_ADDHAHI",
    "DDIMDepthEstimate_ResVis",
    "DDIMDepthEstimate_Swin_ADDHAHIVis",
    "DDIMDepthEstimate_MPVIT_ADDHAHI",
    # the reference's unregistered 'bins' heads (not ported yet)
    "DDIMDepthEstimate_Swin",
    "DDIMDepthEstimate_Swin_Bins_ADDVis",
)


@dataclass
class Config:
    # ---- Dataset (reference src/config.py:11-39) ----
    dir_data: str = "/HDD/dataset/NYUDepthV2_HDF5"
    data_name: str = "NYU"  # NYU | KITTIDC | Synthetic
    split_json: str = "../data_json/kitti_dc.json"
    patch_height: int = 228
    patch_width: int = 304
    top_crop: int = 0

    # ---- Hardware (reference src/config.py:41-61) ----
    seed: int = 7240
    gpus: str = "0,1,2,3"  # flag parity; the port runs on one GPU
    port: str = "29500"
    num_threads: int = 1
    no_multiprocessing: bool = False

    # ---- Network (reference src/config.py:63-134) ----
    model_name: str = "NLSPN"
    network: str = "resnet34"  # NLSPN encoder
    from_scratch: bool = False
    prop_time: int = 18
    prop_kernel: int = 3
    preserve_input: bool = False
    affinity: str = "TGASS"
    affinity_gamma: float = 0.5
    conf_prop: bool = True
    legacy: bool = False
    # NLSPN propagation radius of the JAX package's stencil path (NLSPN is
    # not ported yet)
    prop_stencil_radius: int = 6

    backbone_module: str = "mmbev_resnet"
    backbone_name: str = "mmbev_res18"
    head_specify: Optional[str] = None

    inference_steps: int = 20
    num_train_timesteps: int = 1000
    # 'uniform' (scheduling_ddim) | 'biased' (scheduling_ddim_si SI table)
    timestep_schedule: str = "uniform"
    # ip_basic densification of the sparse depth_map in the datasets
    ip_basic: bool = False

    # ---- Training (reference src/config.py:146-203) ----
    loss: str = "1.0*L1+1.0*L2+1.0*DDIM"
    opt_level: str = "O0"  # O0 = float32; O1/O2/O3 = bfloat16 compute
    pretrain: Optional[str] = None
    resume: bool = False
    force_maxdepth: bool = False
    test_only: bool = False
    epochs: int = 20
    batch_size: int = 12
    max_depth: float = 88.0
    min_depth: float = 1e-6
    augment: bool = True
    num_sample: int = 0
    test_crop: bool = False
    with_loss_chamfer: bool = False

    # ---- Summary (reference src/config.py:205-209) ----
    num_summary: int = 4

    # ---- Optimizer (reference src/config.py:211-257) ----
    lr: float = 0.001
    decay: str = "10,15,20"
    gamma: str = "1.0,0.2,0.04"
    optimizer: str = "ADAM"
    momentum: float = 0.9
    betas: Tuple[float, float] = (0.9, 0.999)
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    warm_up: bool = True
    split_backbone_training: bool = False

    # ---- Logs (reference src/config.py:259-280) ----
    save: str = "trial"
    save_full: bool = False
    save_image: bool = False
    save_result_only: bool = False
    save_raw_npdepth: bool = False

    # ---- extensions of the JAX package (no reference equivalent) ----
    dtype: Optional[str] = None  # compute dtype override: float32|bfloat16
    # e.g. "data:8": one process per device (parallel/mesh.py)
    mesh_shape: Optional[str] = None
    test_batch_size: int = 1  # the reference evaluates at batch 1
    # gradient accumulation: micro-batches per optimizer step, so the
    # reference's global batch 8 (8 GPUs x DDP) trains on one card
    accum_steps: int = 1
    tta_flip: bool = False  # flip-ensemble TTA (leaderboard protocol)
    prefetch: int = 2  # batches the training loader decodes ahead
    # Swin window attention: use_pallas runs the split q/k/v kernel (K8) at
    # eval and the einsum path in training; fused_window_attention=False
    # takes the einsum path everywhere; otherwise WindowAttentionQKV (K4/K7)
    use_pallas: bool = False
    fused_window_attention: bool = True
    # rematerialise each Swin block in the training backward
    remat_backbone: bool = True
    # the denoiser takes the fused conv chain (K1/K5) where its guard holds
    # ('upsample_add', bf16, latent height % 8 == 0)
    fused_denoiser: bool = True
    # comma-separated pyramid channels overriding the head's spec
    head_in_channels: Optional[str] = None
    log_every: int = 50
    # write a torch.profiler trace of steps 10-15 of the first epoch here
    profile_dir: Optional[str] = None

    # ---- Derived (filled by finalize(); reference src/config.py:284-288) ----
    num_gpus: int = 4
    save_dir: str = ""

    def finalize(self) -> "Config":
        self.num_gpus = len(self.gpus.split(","))
        if not self.save_dir:
            current_time = time.strftime("%y%m%d_%H%M%S_")
            self.save_dir = "../experiments/" + current_time + self.save
        if self.dtype is None:
            self.dtype = "float32" if self.opt_level == "O0" else "bfloat16"
        if mesh_axes(self.mesh_shape).get("model", 1) > 1:
            raise NotImplementedError(
                f"--mesh_shape {self.mesh_shape}: tensor parallelism over a 'model' axis "
                "(JAX's state_sharding) is not ported yet: ROADMAP, 'The port slices left', "
                "item 1")
        return self

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype or "float32"]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if isinstance(kwargs.get("betas"), list):
            kwargs["betas"] = tuple(kwargs["betas"])
        return cls(**kwargs).finalize()

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @classmethod
    def load_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def build_parser() -> argparse.ArgumentParser:
    """Argparse front end with flag names identical to the reference CLI."""
    p = argparse.ArgumentParser(description="DiffusionDepth (PyTorch/CUDA)")
    d = Config()

    # Dataset
    p.add_argument("--dir_data", type=str, default=d.dir_data)
    p.add_argument("--data_name", type=str, default=d.data_name,
                   choices=("NYU", "KITTIDC", "Synthetic"))
    p.add_argument("--split_json", type=str, default=d.split_json)
    p.add_argument("--patch_height", type=int, default=d.patch_height)
    p.add_argument("--patch_width", type=int, default=d.patch_width)
    p.add_argument("--top_crop", type=int, default=d.top_crop)
    # Hardware
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--gpus", type=str, default=d.gpus)
    p.add_argument("--port", type=str, default=d.port)
    p.add_argument("--num_threads", type=int, default=d.num_threads)
    p.add_argument("--no_multiprocessing", action="store_true", default=False)
    # Network
    p.add_argument("--model_name", type=str, default=d.model_name, choices=MODEL_CHOICES)
    p.add_argument("--network", type=str, default=d.network,
                   choices=("resnet18", "resnet34"))
    p.add_argument("--from_scratch", action="store_true", default=False)
    p.add_argument("--prop_time", type=int, default=d.prop_time)
    p.add_argument("--prop_kernel", type=int, default=d.prop_kernel)
    p.add_argument("--preserve_input", action="store_true", default=False)
    p.add_argument("--prop_stencil_radius", type=int,
                   default=d.prop_stencil_radius)
    p.add_argument("--affinity", type=str, default=d.affinity,
                   choices=("AS", "ASS", "TC", "TGASS"))
    p.add_argument("--affinity_gamma", type=float, default=d.affinity_gamma)
    p.add_argument("--conf_prop", action="store_true", default=True)
    p.add_argument("--no_conf", action="store_false", dest="conf_prop")
    p.add_argument("--legacy", action="store_true", default=False)
    p.add_argument("--backbone_module", type=str, default=d.backbone_module,
                   choices=BACKBONE_MODULE_CHOICES)
    p.add_argument("--backbone_name", type=str, default=d.backbone_name,
                   choices=BACKBONE_NAME_CHOICES)
    p.add_argument("--head_specify", type=str, default=None, choices=HEAD_CHOICES)
    p.add_argument("--inference_steps", type=int, default=d.inference_steps)
    p.add_argument("--num_train_timesteps", type=int, default=d.num_train_timesteps)
    p.add_argument("--timestep_schedule", type=str, default=d.timestep_schedule,
                   choices=("uniform", "biased"))
    p.add_argument("--ip_basic", action="store_true", default=False,
                   help="densify the sparse depth_map with ip_basic "
                   "fill_in_multiscale host-side (the reference's "
                   "constructor-only ip_basic=True branch, "
                   "diffusion_dcbase_model.py:96-115)")
    # Training
    p.add_argument("--loss", type=str, default=d.loss)
    p.add_argument("--opt_level", type=str, default=d.opt_level,
                   choices=("O0", "O1", "O2", "O3"))
    p.add_argument("--pretrain", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--force_maxdepth", action="store_true")
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--max_depth", type=float, default=d.max_depth)
    p.add_argument("--min_depth", type=float, default=d.min_depth)
    p.add_argument("--augment", type=bool, default=True)
    p.add_argument("--no_augment", action="store_false", dest="augment")
    p.add_argument("--num_sample", type=int, default=d.num_sample)
    p.add_argument("--test_crop", action="store_true", default=False)
    p.add_argument("--with_loss_chamfer", action="store_true", default=False)
    # Summary
    p.add_argument("--num_summary", type=int, default=d.num_summary)
    # Optimizer
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--decay", type=str, default=d.decay)
    p.add_argument("--gamma", type=str, default=d.gamma)
    p.add_argument("--optimizer", default=d.optimizer, choices=("SGD", "ADAM", "RMSprop"))
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--epsilon", type=float, default=d.epsilon)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--warm_up", action="store_true", default=True)
    p.add_argument("--no_warm_up", action="store_false", dest="warm_up")
    p.add_argument("--split_backbone_training", action="store_true")
    # Logs
    p.add_argument("--save", type=str, default=d.save)
    p.add_argument("--save_full", action="store_true", default=False)
    p.add_argument("--save_image", action="store_true", default=False)
    p.add_argument("--save_result_only", action="store_true", default=False)
    p.add_argument("--save_raw_npdepth", action="store_true", default=False)
    # extensions of the JAX package
    p.add_argument("--dtype", type=str, default=None, choices=("float32", "bfloat16"))
    p.add_argument("--mesh_shape", type=str, default=None)
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--accum_steps", type=int, default=d.accum_steps)
    p.add_argument("--prefetch", type=int, default=d.prefetch)
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--tta_flip", action="store_true", default=False)
    p.add_argument("--use_pallas", action="store_true", default=False)
    p.add_argument("--no_fused_window_attention", dest="fused_window_attention",
                   action="store_false", default=True)
    p.add_argument("--no_remat_backbone", dest="remat_backbone",
                   action="store_false", default=True)
    p.add_argument("--no_fused_denoiser", dest="fused_denoiser",
                   action="store_false", default=True)
    p.add_argument("--head_in_channels", type=str, default=None,
                   help="comma-separated pyramid channels overriding the "
                        "head's reference spec (e.g. 96,192,384,768)")
    return p


def parse_args(argv: Optional[List[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config.from_dict(vars(ns))


def mesh_axes(spec: Optional[str]) -> Dict[str, int]:
    """The axes of a ``--mesh_shape`` spec such as "data:4,model:2"; empty
    when it is not given."""
    axes = {}
    for part in (spec or "").split(","):
        if part.strip():
            name, size = part.split(":")
            axes[name.strip()] = int(size)
    return axes


def mesh_devices(spec: Optional[str]) -> int:
    """The number of devices a ``--mesh_shape`` spec asks for; 1 when it
    is not given."""
    n = 1
    for size in mesh_axes(spec).values():
        n *= size
    return n


def convert_str_to_num(val: str, t: str) -> List:
    """'10,15,20' -> [10, 15, 20] (``t`` is 'int' or 'float')."""
    cast = {"int": int, "float": float}[t]
    return [cast(v) for v in val.replace("'", "").replace('"', "").split(",")]
