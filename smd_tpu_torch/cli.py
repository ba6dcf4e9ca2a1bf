"""Shared CLI flags and helpers (port of ``smd_tpu/cli.py``).

The flags of the JAX package's ``define_common_flags``,
``define_diffusion_flags`` and ``define_sampling_flags``, with the same
names, defaults and choices, so the layered ``configs/*.cfg`` flagfiles
work unchanged; plus ``--device`` (``cuda`` unless ``cpu`` is asked for).
The card has no ``absl``, so ``Flags`` parses them itself, as absl does:
``--flagfile=`` (recursive; paths relative to the working directory;
blank lines and lines starting with ``#`` or ``//`` skipped), later
values over earlier ones, ``--name`` / ``--noname`` and ``--name=true``
for booleans, comma lists, ``--name value``, and an error on an unknown
flag. Unlike absl's, each parse starts from the defaults, and a group of
flags defined again (``train_ncsn`` and ``sample_ncsn`` in one process)
is kept as it is.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, List, Sequence

import torch

from smd_tpu_torch.device import resolve_device
from smd_tpu_torch.diffusion import schedules
from smd_tpu_torch.models import get_model
from smd_tpu_torch.training.diffusion import TrainConfig

log = logging.getLogger("smd_tpu_torch")

__all__ = ["FLAGS", "Flags", "FlagsError", "define_common_flags",
           "define_diffusion_flags", "define_sampling_flags",
           "train_config_from_flags", "model_from_flags", "latent_width",
           "serving_model_fn",
           "schedule_from_flags", "initialize_from_flags",
           "mesh_from_flags", "dataset_from_flags",
           "load_transforms_from_flags", "restore_state_for_sampling"]


class FlagsError(ValueError):
    """An unknown flag or a value a flag does not take."""


_TRUE = ("true", "t", "1")
_FALSE = ("false", "f", "0")


@dataclasses.dataclass
class _Flag:
    default: Any
    parse: Callable[[str], Any]
    help: str
    boolean: bool = False


class Flags:
    """A registry of flags and their parsed values (``FLAGS.name``)."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._values: Dict[str, Any] = {}

    def __getattr__(self, name):
        if name.startswith("_") or name not in self._values:
            raise AttributeError(f"no flag --{name}")
        return self._values[name]

    def __contains__(self, name):
        return name in self._flags

    def _define(self, name, default, parse, help, boolean=False):
        if name in self._flags:
            raise FlagsError(f"flag --{name} is defined twice")
        self._flags[name] = _Flag(default, parse, help, boolean)
        self._values[name] = default

    def names(self) -> List[str]:
        return list(self._flags)

    def __call__(self, argv: Sequence[str]) -> List[str]:
        """Parse ``argv`` (``argv[0]`` is the program) from the defaults;
        returns the program and the arguments that are not flags."""
        for name, flag in self._flags.items():
            self._values[name] = flag.default
        rest = [argv[0]] if argv else []
        self._parse(list(argv[1:]), rest, depth=0)
        return rest

    def _parse(self, args, rest, depth):
        if depth > 32:
            raise FlagsError("flagfiles nest more than 32 deep")
        i = 0
        while i < len(args):
            arg = args[i]
            i += 1
            if not arg.startswith("-") or arg in ("-", "--"):
                rest.append(arg)
                continue
            name, eq, value = arg.lstrip("-").partition("=")
            if name == "flagfile":
                if not eq:
                    value, i = args[i], i + 1
                self._parse(self._read_flagfile(value), rest, depth + 1)
                continue
            flag = self._flags.get(name)
            if flag is None and name.startswith("no") and not eq:
                flag = self._flags.get(name[2:])
                if flag is not None and flag.boolean:
                    self._values[name[2:]] = False
                    continue
                flag = None
            if flag is None:
                raise FlagsError(f"Unknown command line flag '{name}'")
            if flag.boolean and not eq:
                self._values[name] = True
                continue
            if not eq:
                if i >= len(args):
                    raise FlagsError(f"flag --{name} needs a value")
                value, i = args[i], i + 1
            try:
                self._values[name] = flag.parse(value)
            except ValueError as e:
                raise FlagsError(f"flag --{name}={value}: {e}") from None

    @staticmethod
    def _read_flagfile(path) -> List[str]:
        with open(os.path.expanduser(path)) as f:
            lines = [ln.strip() for ln in f]
        return [ln for ln in lines
                if ln and not ln.startswith("#") and not ln.startswith("//")]

    # -- definitions, absl's names -------------------------------------------
    def DEFINE_integer(self, name, default, help):
        self._define(name, default, int, help)

    def DEFINE_float(self, name, default, help):
        self._define(name, None if default is None else float(default),
                     float, help)

    def DEFINE_string(self, name, default, help):
        self._define(name, default, str, help)

    def DEFINE_boolean(self, name, default, help):
        def parse(value):
            if value.lower() in _TRUE:
                return True
            if value.lower() in _FALSE:
                return False
            raise ValueError("not a boolean")
        self._define(name, default, parse, help, boolean=True)

    def DEFINE_enum(self, name, default, choices, help):
        def parse(value):
            if value not in choices:
                raise ValueError(
                    f"value should be one of <{'|'.join(choices)}>")
            return value
        self._define(name, default, parse, help)

    def DEFINE_list(self, name, default, help):
        def parse(value):
            return [s.strip() for s in value.split(",")] if value else []
        self._define(name, default, parse, help)


FLAGS = Flags()


def define_common_flags():
    F = FLAGS
    if "seed" in F:   # an entry point imported earlier defined them
        return
    F.DEFINE_integer("seed", 0, "Random seed for network initialization.")
    # Training
    F.DEFINE_float("learning_rate", 3e-4, "Learning rate for optimizer.")
    F.DEFINE_integer("batch_size", 128, "Batch size for training.")
    F.DEFINE_integer("epochs", 10, "Number of training epochs.")
    F.DEFINE_integer("max_steps", None, "Maximum number of training steps.")
    # Training stability
    F.DEFINE_boolean("early_stopping", False,
                     "Use early stopping to prevent overfitting.")
    F.DEFINE_float("grad_clip", 1.0, "Max gradient norm for training.")
    F.DEFINE_float("lr_gamma", 0.98, "Gamma for learning rate scheduler.")
    F.DEFINE_integer("lr_schedule_interval", 10000,
                     "Number of steps between LR changes.")
    F.DEFINE_float("lr_warmup", 0, "Learning rate warmup (steps).")
    # Model
    F.DEFINE_string("architecture", "TransformerDDPM",
                    "Class name of model architecture.")
    F.DEFINE_integer("num_layers", 6, "Number of encoder layers.")
    F.DEFINE_integer("num_heads", 8, "Number of attention heads.")
    F.DEFINE_integer("num_mlp_layers", 2, "Number of MLP layers.")
    F.DEFINE_integer("mlp_dims", 2048, "Number of channels per MLP layer.")
    F.DEFINE_integer("mdn_components", 100, "Number of mixtures.")
    # Data
    F.DEFINE_list("data_shape", [2], "Shape of data.")
    F.DEFINE_enum("problem", "toy", ["toy", "mnist", "vae", "tokens"],
                  "Problem to solve.")
    F.DEFINE_string(
        "dataset", "./output/mix2d",
        "Path to directory containing data as train/eval tfrecord files.")
    F.DEFINE_string("pca_ckpt", "", "PCA transform.")
    F.DEFINE_string("slice_ckpt", "", "Slice transform.")
    F.DEFINE_string("dim_weights_ckpt", "", "Dimension scale transform.")
    F.DEFINE_boolean("normalize", True, "Normalize dataset to [-1, 1].")
    # Logging, checkpointing, and evaluation
    F.DEFINE_integer("logging_freq", 100, "Logging frequency.")
    F.DEFINE_integer("snapshot_freq", 5000,
                     "Evaluation and checkpoint frequency.")
    F.DEFINE_boolean("snapshot_sampling", True,
                     "Sample from score network during evaluation.")
    F.DEFINE_integer("eval_samples", 3000, "Number of samples to generate.")
    F.DEFINE_integer("checkpoints_to_keep", 50,
                     "Number of checkpoints to keep.")
    F.DEFINE_boolean("save_ckpt", True,
                     "Save model checkpoints at each evaluation step.")
    F.DEFINE_string("model_dir", "./save/ncsn",
                    "Directory to store model data.")
    F.DEFINE_boolean("verbose", True, "Toggle logging to stdout.")
    # Parallelism / scale
    F.DEFINE_integer("model_parallelism", 1,
                     "Size of the tensor-parallel mesh axis.")
    F.DEFINE_integer("scan_chunk", 1,
                     "Optimizer steps taken as one chunk (the JAX package's "
                     "lax.scan dispatch): on the card one step captured in "
                     "a CUDA graph and replayed this many times, on the CPU "
                     "as many eager steps; snapshots, checkpoints and "
                     "max_steps land where the per-step loop puts them, and "
                     "logging is by chunk. 1 = one eager step at a time; "
                     "under torchrun, on any --model_parallelism, each of "
                     "the step's collectives runs eagerly between two of "
                     "its captured graphs; with --remat the captured "
                     "backward recomputes each transformer layer.")
    F.DEFINE_boolean("mixed_precision", False,
                     "bfloat16 compute with fp32 params.")
    F.DEFINE_boolean("adam_m_bf16", False,
                     "Store Adam's first moment in bfloat16. The EMA stays "
                     "fp32.")
    F.DEFINE_boolean("remat", False,
                     "Rematerialize transformer layers in the backward "
                     "pass (activation checkpointing), in eager steps and "
                     "in the captured --scan_chunk alike.")
    F.DEFINE_string("device", "cuda",
                    "Device to run on: cuda (the default; raises without a "
                    "GPU) or cpu.")


def define_diffusion_flags():
    F = FLAGS
    if "loss" in F:
        return
    F.DEFINE_enum("loss", "dsm", ["dsm", "ssm", "ddpm"], "Loss function.")
    F.DEFINE_boolean("continuous_noise", True,
                     "Continuous noise conditioning.")
    # Noise schedule
    F.DEFINE_float("sigma_begin", 1.0, "Starting variance for noise schedule.")
    F.DEFINE_float("sigma_end", 1e-2, "Ending variance for noise schedule.")
    F.DEFINE_enum("schedule_type", "geometric",
                  ["geometric", "linear", "fibonacci", "cosine"],
                  "Noise schedule configuration (cosine: improved-DDPM "
                  "betas; sigma_begin/sigma_end ignored).")
    F.DEFINE_integer("num_sigmas", 15,
                     "Number of sigma values (L) in noise schedule.")
    # Langevin dynamics (NCSN only)
    F.DEFINE_integer("ld_steps", 100,
                     "Number of steps for annealed Langevin dynamics.")
    F.DEFINE_float("ld_epsilon", 2e-6,
                   "Step size for annealed Langevin dynamics.")
    # Sampling
    F.DEFINE_enum("sampling", "ald",
                  ["ald", "cas", "ddpm", "ddim", "dpmpp", "distilled",
                   "consistency"],
                  "Sampling algorithm to use.")
    # Distillation (training/distill.py, training/consistency.py)
    F.DEFINE_boolean("distill", False,
                     "Progressively distill the latest checkpoint for "
                     "few-step sampling instead of training.")
    F.DEFINE_enum("distill_mode", "progressive",
                  ["progressive", "consistency", "ct"],
                  "Distillation objective.")
    F.DEFINE_integer("consistency_segments", 32,
                     "Consistency-distillation discretization N.")
    F.DEFINE_string("ct_seg_schedule", "16,32,64,128",
                    "Discretization curriculum for --distill_mode=ct.")
    F.DEFINE_float("ct_p_mean", -1.1,
                   "Mean of iCT's lognormal noise-level distribution.")
    F.DEFINE_float("ct_p_std", 2.0,
                   "Std of iCT's lognormal noise-level distribution.")
    F.DEFINE_integer("distill_start_steps", 8,
                     "First (largest) distilled sampler step count.")
    F.DEFINE_integer("distill_end_steps", 2,
                     "Final (smallest) distilled sampler step count.")
    F.DEFINE_integer("distill_stage_steps", 3000,
                     "Optimizer steps per distillation stage.")
    F.DEFINE_float("distill_lr", 1e-4,
                   "Learning rate for distillation stages.")
    F.DEFINE_float("distill_lam_max", 2.5,
                   "Half-log-SNR cap for the distillation grid's clean end.")
    F.DEFINE_integer("ddim_steps", 50,
                     "Number of strided steps for DDIM sampling.")
    F.DEFINE_integer("consistency_sampling_steps", 0,
                     "Refinement step count for --sampling=consistency.")
    F.DEFINE_float("ddim_eta", 0.0,
                   "DDIM stochasticity (0 = deterministic ODE).")
    F.DEFINE_boolean("ema", True, "Exponential moving average smoothing.")
    F.DEFINE_float("mu", 0.999, "Momentum parameter for EMA.")
    F.DEFINE_boolean(
        "denoise", True,
        "Add additional denoising step during sampling (Song et al., 2020).")


def define_sampling_flags():
    F = FLAGS
    if "sample_seed" in F:
        return
    F.DEFINE_integer("sample_seed", 1,
                     "Random number generator seed for sampling.")
    F.DEFINE_enum("sampling_dtype", "bfloat16", ["float32", "bfloat16"],
                  "Compute dtype for the sampling forward pass (bfloat16 "
                  "off the CPU; the CPU keeps float32).")
    F.DEFINE_string("sampling_dir", "samples", "Sampling directory.")
    F.DEFINE_integer("sample_size", 1000, "Number of samples.")
    F.DEFINE_boolean("compute_metrics", False,
                     "Compute evaluation metrics for generated samples.")
    F.DEFINE_boolean("compute_final_only", False,
                     "Do not include metrics for intermediate samples.")
    F.DEFINE_boolean("flush", True, "Flush generated samples to disk.")
    F.DEFINE_boolean("animate", False, "Generate animation of samples.")
    F.DEFINE_boolean("infill", False, "Infill.")
    F.DEFINE_boolean("interpolate", False, "Interpolate.")


def train_config_from_flags(mdn: bool = False) -> TrainConfig:
    """The TrainConfig of the flags. ``mdn``: no objective or noise fields
    (the MDN entry points define no diffusion flags) and no EMA."""
    cfg = TrainConfig(
        learning_rate=FLAGS.learning_rate,
        batch_size=FLAGS.batch_size,
        epochs=FLAGS.epochs,
        max_steps=FLAGS.max_steps,
        early_stopping=FLAGS.early_stopping,
        grad_clip=FLAGS.grad_clip,
        lr_gamma=FLAGS.lr_gamma,
        lr_schedule_interval=FLAGS.lr_schedule_interval,
        lr_warmup=int(FLAGS.lr_warmup),
        logging_freq=FLAGS.logging_freq,
        snapshot_freq=FLAGS.snapshot_freq,
        checkpoints_to_keep=FLAGS.checkpoints_to_keep,
        save_ckpt=FLAGS.save_ckpt,
        verbose=FLAGS.verbose,
        scan_chunk=FLAGS.scan_chunk,
        adam_m_bf16=FLAGS.adam_m_bf16,
    )
    if mdn:
        cfg.ema = False
    else:
        cfg.loss = FLAGS.loss
        cfg.continuous_noise = FLAGS.continuous_noise
        cfg.ema = FLAGS.ema
        cfg.mu = FLAGS.mu
    return cfg


def model_from_flags(data_channels: int, mdn: bool = False, dtype=None,
                     device=None):
    """The flag-built architecture on ``--device`` (or ``device``).

    ``data_channels`` is the latent width, which Flax infers from the
    input. ``--mixed_precision`` computes in bfloat16 with float32 params
    (the layers cast at compute time); ``dtype`` overrides it. ``mdn``
    passes ``--mdn_components`` as the mixture count.
    """
    kwargs = dict(num_layers=FLAGS.num_layers, num_heads=FLAGS.num_heads,
                  num_mlp_layers=FLAGS.num_mlp_layers,
                  mlp_dims=FLAGS.mlp_dims, remat=FLAGS.remat)
    if FLAGS.mixed_precision:
        kwargs["dtype"] = torch.bfloat16
    if dtype is not None:
        kwargs["dtype"] = dtype
    if mdn:
        kwargs["mdn_mixtures"] = FLAGS.mdn_components
    return get_model(FLAGS.architecture,
                     device=FLAGS.device if device is None else device,
                     data_channels=data_channels, **kwargs)


# Where a params tree of each architecture holds the latent width: the
# input layer's kernel, and its axis of input channels.
_INPUT_KERNEL = {"TransformerDDPM": ("TransformerEncoder_0.Dense_0.kernel", 0),
                 "TransformerDDPM4": ("TransformerEncoder_0.Dense_0.kernel",
                                      0),
                 "ConvNCSN": ("Conv_0.kernel", 1)}


def latent_width(params: Dict[str, torch.Tensor]) -> int:
    """The latent width of ``--architecture``'s params tree: the rows of
    the first Dense's kernel, or ConvNCSN's input channels."""
    key, axis = _INPUT_KERNEL.get(FLAGS.architecture, ("Dense_0.kernel", 0))
    return params[key].shape[axis]


def serving_model_fn(params: Dict[str, torch.Tensor], mdn: bool = False):
    """(x, cond) -> float32 output closure over ``params`` ({name: tensor},
    e.g. ``state.sampling_params``), honoring ``--sampling_dtype``.

    At bfloat16 (where the sampling flags are defined and say so) and off
    the CPU: the flag-built architecture computing in bf16 with its params
    cast to bf16, float32 in and out. Otherwise float32, which also
    overrides a ``--mixed_precision`` inherited from a train flagfile.
    No gradient is recorded.
    """
    device = resolve_device(FLAGS.device)
    channels = latent_width(params)
    if "sampling_dtype" in FLAGS and FLAGS.sampling_dtype == "bfloat16" \
            and device.type != "cpu":
        dtype = torch.bfloat16
    else:
        dtype = torch.float32
    model = model_from_flags(channels, mdn=mdn, dtype=dtype, device=device)
    model.load_state_dict(params)
    model = model.to(dtype).eval().requires_grad_(False)
    return lambda x, cond: model(x.to(dtype), cond.to(dtype)).float()


def schedule_from_flags():
    return schedules.noise_schedule(FLAGS.sigma_begin, FLAGS.sigma_end,
                                    FLAGS.num_sigmas,
                                    kind=FLAGS.schedule_type)


def initialize_from_flags():
    """Join the process group that torchrun's variables declare (NCCL on
    ``--device=cuda``, one card a rank; gloo on the CPU) and return
    (rank, world size); (0, 1) without them. See
    ``parallel.mesh.initialize_distributed``."""
    from smd_tpu_torch.parallel import mesh as mesh_lib
    rank, world = mesh_lib.initialize_distributed(FLAGS.device)
    if world > 1:
        log.info("distributed: rank %d of %d on %s", rank, world,
                 resolve_device(FLAGS.device))
    return rank, world


def mesh_from_flags():
    """The (data, model) mesh over the process group, ``--model_parallelism``
    ranks a model group; None on one rank without a model axis."""
    from smd_tpu_torch.parallel import mesh as mesh_lib
    _, world = _world()
    model_axis = max(1, FLAGS.model_parallelism)
    if world == 1 and model_axis == 1:
        return None
    return mesh_lib.make_mesh(
        mesh_lib.MeshConfig(data=world // model_axis, model=model_axis))


def _world():
    """(rank, world size) of the default group; (0, 1) without one."""
    import torch.distributed as dist
    started = dist.is_available() and dist.is_initialized()
    return (dist.get_rank(), dist.get_world_size()) if started else (0, 1)


def dataset_from_flags(include_cardinality=True, problem=None):
    """(train, eval) Datasets of the flags. ``--batch_size`` is the global
    batch: across ranks each rank of a model group reads the same shard,
    shard ``rank // --model_parallelism`` of ``world //
    --model_parallelism``, in batches of the global batch over that
    count."""
    from smd_tpu_torch.data import pipeline
    rank, world = _world()
    model_axis = max(1, FLAGS.model_parallelism)
    count = max(world // model_axis, 1)
    if FLAGS.batch_size % count:
        raise ValueError(f"batch_size {FLAGS.batch_size} must divide by "
                         f"process_count {count}")
    return pipeline.get_dataset(
        dataset=FLAGS.dataset,
        data_shape=FLAGS.data_shape,
        problem=problem if problem is not None else FLAGS.problem,
        batch_size=FLAGS.batch_size // count,
        normalize=FLAGS.normalize,
        pca_ckpt=FLAGS.pca_ckpt,
        slice_ckpt=FLAGS.slice_ckpt,
        dim_weights_ckpt=FLAGS.dim_weights_ckpt,
        include_cardinality=include_cardinality,
        shard_index=rank // model_axis,
        shard_count=count,
        seed=FLAGS.seed)


def load_transforms_from_flags():
    from smd_tpu_torch.utils import io as io_lib
    pca = io_lib.load(os.path.expanduser(
        FLAGS.pca_ckpt)) if FLAGS.pca_ckpt else None
    slice_idx = io_lib.load(os.path.expanduser(
        FLAGS.slice_ckpt)) if FLAGS.slice_ckpt else None
    dim_weights = io_lib.load(os.path.expanduser(
        FLAGS.dim_weights_ckpt)) if FLAGS.dim_weights_ckpt else None
    return pca, slice_idx, dim_weights


def restore_state_for_sampling(input_shape, mdn: bool = False):
    """Rebuild the model from flags and restore the latest checkpoint."""
    from smd_tpu_torch.training import diffusion as dtrainer
    from smd_tpu_torch.training import mdn as mtrainer
    from smd_tpu_torch.utils.checkpoints import CheckpointManager

    model = model_from_flags(input_shape[-1], mdn=mdn)
    config = train_config_from_flags(mdn=mdn)
    trainer = mtrainer if mdn else dtrainer
    state = trainer.create_train_state(model, config, FLAGS.seed)
    manager = CheckpointManager(f"{FLAGS.model_dir}/ckpt",
                                keep=config.checkpoints_to_keep)
    if manager.latest_step is None:
        raise FileNotFoundError(
            f"No checkpoint found under {FLAGS.model_dir}/ckpt")
    state = manager.restore_latest(state)
    manager.close()
    return model, state
