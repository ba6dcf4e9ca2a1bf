"""MusicVAE latent codec in PyTorch (port of ``smd_tpu/codec/musicvae.py``).

The cat-mel_2bar_big architecture (BiLSTM-2048 encoder -> 512-d latent,
3x2048 LSTM categorical decoder) and the hierarchical configs (a conductor
LSTM expands z into per-segment embeddings, each decoded by the core
decoder), with the JAX package's parameter names and layouts, so a Flax
params tree (the shipped ``checkpoints/musicvae-*.pkl`` bundles) loads with
``utils.flax_params.load_flax_params``:

- ``encoder/OptimizedLSTMCell_0`` (forward) and ``_1`` (backward): Flax
  names the cells by the scope that builds them, ``Encoder``'s, not by the
  ``nn.RNN`` wrappers ``fwd``/``bwd``; ``encoder/mu``, ``encoder/sigma``;
- ``decoder/z_to_initial_state``, ``decoder/cell/lstm_{i}``,
  ``decoder/cell/logits``;
- ``conductor/z_to_state``, ``conductor/cell/lstm_{i}``,
  ``conductor/cell/segment_embedding``.

Each LSTM cell computes what ``flax.linen.OptimizedLSTMCell`` computes. The
time loops are Python loops over one step each (JAX scans them); the four
gates' kernels are put side by side once per call, not once per step.
Training: ``elbo_loss`` and scheduled sampling in the teacher-forced
decoder, whose draws replay through ``gumbel=`` and ``ss_mix=`` as the
sampled decode's do through ``gumbel=``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from smd_tpu_torch.codec.melody import MelodyConverter, melody_2bar_converter
from smd_tpu_torch.device import resolve_device
from smd_tpu_torch.models.layers import Dense

__all__ = ["MusicVAEConfig", "MusicVAE", "TrainedMusicVAE", "LSTMCell",
           "Encoder", "Decoder", "DecoderCell", "Conductor", "ConductorCell",
           "normalize_config", "normalize_params", "MEL_2BAR_BIG",
           "MEL_16BAR_HIERDEC", "gumbel_noise", "elbo_loss"]

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MusicVAEConfig:
    latent_dims: int = 512
    enc_units: int = 2048
    dec_units: Tuple[int, ...] = (2048, 2048, 2048)
    depth: int = 90           # melody vocab
    max_seq_len: int = 32     # 2 bars at 16 steps/bar
    free_bits: float = 0.0
    beta: float = 0.2
    # Hierarchical decoding (hierdec-mel_16bar / hier-multiperf analogue):
    # a conductor RNN expands z into per-segment embeddings, each decoded by
    # the core decoder. 0 = flat decoding.
    hier_segments: int = 0
    conductor_units: int = 1024
    # magenta's hierdec-mel_16bar conductor is a 2-layer [1024, 1024] LSTM.
    conductor_layers: int = 2


def _conductor_layers(cfg) -> int:
    """Conductor depth; tolerates configs pickled before the field existed."""
    return getattr(cfg, "conductor_layers", 1)


def normalize_config(cfg) -> MusicVAEConfig:
    """Re-instantiate a (possibly old, pickled) config with current fields."""
    fields = {f.name for f in dataclasses.fields(MusicVAEConfig)}
    kwargs = {k: v for k, v in vars(cfg).items() if k in fields}
    # Configs pickled before conductor_layers existed were 1-layer.
    kwargs.setdefault("conductor_layers", 1)
    return MusicVAEConfig(**kwargs)


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def normalize_params(params):
    """Upgrade param trees from bundles pickled before layout renames.

    The single-layer conductor LSTM was once named ``lstm``; the stacked
    conductor renamed it ``lstm_0``. Renamed in a copy of every dict level,
    so the caller's tree is left as it is.
    """
    try:
        cell = params["params"]["conductor"]["cell"]
    except (KeyError, TypeError):
        return params
    if "lstm" in cell and "lstm_0" not in cell:
        params = _copy_tree(params)
        cell = params["params"]["conductor"]["cell"]
        cell["lstm_0"] = cell.pop("lstm")
    return params


MEL_2BAR_BIG = MusicVAEConfig()
MEL_16BAR_HIERDEC = MusicVAEConfig(max_seq_len=256, hier_segments=16)

# The shipped codecs (the JAX package's scripts/train_musicvae.py), loaded
# automatically when a TrainedMusicVAE of their shapes is built without
# params, as in the JAX package.
_CKPT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "checkpoints")
DEFAULT_MELODY_ARTIFACT = os.path.join(_CKPT_DIR, "musicvae-melody.pkl")
# Full-size cat-mel_2bar_big; preferred over the reduced one when present.
DEFAULT_MELODY_BIG_ARTIFACT = os.path.join(
    _CKPT_DIR, "musicvae-melody-big.pkl")
DEFAULT_MULTI_ARTIFACT = os.path.join(_CKPT_DIR, "musicvae-multi.pkl")
DEFAULT_MELODY16_ARTIFACT = os.path.join(_CKPT_DIR, "musicvae-melody16.pkl")


def _load_artifact(path):
    if not os.path.exists(path):
        return None
    from smd_tpu_torch.utils import io as io_lib
    return io_lib.load(path)


def load_default_melody_params():
    """The shipped melody codec bundle, preferring the full-size
    cat-mel_2bar_big artifact over the reduced one; None when absent."""
    return (_load_artifact(DEFAULT_MELODY_BIG_ARTIFACT) or
            _load_artifact(DEFAULT_MELODY_ARTIFACT))


def load_default_multi_params():
    """The shipped multitrack (hier-multiperf) codec bundle, or None."""
    return _load_artifact(DEFAULT_MULTI_ARTIFACT)


def load_default_melody16_params():
    """The shipped 16-bar hierdec melody codec bundle, or None."""
    return _load_artifact(DEFAULT_MELODY16_ARTIFACT)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws, float32: -log(-log(u)), u uniform in
    [tiny, 1), as ``jax.random.gumbel`` draws them (other bits)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class _RecurrentDense(Dense):
    """A hidden-to-hidden kernel: Flax draws it orthogonal."""

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            value = nn.init.orthogonal_(torch.empty(self.kernel.shape),
                                        generator=generator)
            self.kernel.copy_(value)
            nn.init.zeros_(self.bias)


_GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """``flax.linen.OptimizedLSTMCell``: carry ``(c, h)``; gates in the
    order i, f, g, o from ``x @ W_i* + (h @ W_h* + b_h*)``; i, f, o
    sigmoid, g tanh; ``c' = f·c + i·g``, ``h' = o·tanh(c')``.

    The input kernels ``ii, if, ig, io`` have no bias, the hidden kernels
    ``hi, hf, hg, ho`` have one. With a ``dtype`` the inputs, kernels and
    biases are cast to it before each of the two products (Flax's
    ``promote_dtype``); with None each product computes in the promoted type
    of its operands. ``c`` and ``h`` keep the type the arithmetic promotes
    them to.
    """

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        # "if" is a Python keyword: every gate's submodule is registered by
        # name.
        for g in _GATES:
            self.add_module(f"i{g}", Dense(in_features, features,
                                           use_bias=False))
        for g in _GATES:
            self.add_module(f"h{g}", _RecurrentDense(features, features))

    def _side_by_side(self, prefix, leaf):
        return torch.cat([getattr(getattr(self, prefix + g), leaf)
                          for g in _GATES], dim=-1)

    def input_weights(self, x_dtype: torch.dtype) -> torch.Tensor:
        """W_i = [W_ii W_if W_ig W_io] in the dtype of the input product
        for an input of ``x_dtype``; ``x @ W_i`` is ``input_product``."""
        w = self._side_by_side("i", "kernel")
        return w.to(self.dtype or torch.promote_types(x_dtype, w.dtype))

    def recurrent_weights(self, h_dtype: torch.dtype):
        """(W_h, b_h), the four gates side by side, in the dtype of the
        hidden product for a carry of ``h_dtype``."""
        w = self._side_by_side("h", "kernel")
        b = self._side_by_side("h", "bias")
        dt = self.dtype or torch.promote_types(
            torch.promote_types(h_dtype, w.dtype), b.dtype)
        return w.to(dt), b.to(dt)

    def step(self, carry, xi: torch.Tensor, w_h: torch.Tensor,
             b_h: torch.Tensor):
        """One step from the input product ``xi`` (``input_product`` of
        this step's input and ``input_weights``) and
        ``recurrent_weights``."""
        c, h = carry
        gates = torch.matmul(h.to(w_h.dtype), w_h) + b_h + xi
        u = self.features
        sig = torch.sigmoid(gates)
        i, f, o = sig[:, :u], sig[:, u:2 * u], sig[:, 3 * u:]
        g = torch.tanh(gates[:, 2 * u:3 * u])
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return new_c, new_h

    def weights(self, x_dtype: torch.dtype, h_dtype: torch.dtype):
        """(W_i, W_h, b_h) for inputs of ``x_dtype`` and a carry of
        ``h_dtype``: joined and cast once, then passed to every step."""
        return (self.input_weights(x_dtype),
                *self.recurrent_weights(h_dtype))

    def forward(self, carry, x: torch.Tensor):
        """One step on ``x`` (B, in): returns ``((c', h'), h')``."""
        w_i, w_h, b_h = self.weights(x.dtype, carry[1].dtype)
        new = self.step(carry, input_product(x, w_i), w_h, b_h)
        return new, new[1]


def input_product(x: torch.Tensor, w_i: torch.Tensor) -> torch.Tensor:
    """``x @ W_i`` over any leading axes, in ``W_i``'s dtype."""
    return torch.matmul(x.to(w_i.dtype), w_i)


def _run_lstm(cell: LSTMCell, x: torch.Tensor, reverse: bool = False):
    """The final carry's ``h`` of ``cell`` over ``x`` (B, T, in) from a zero
    float32 carry (``nn.RNN`` with ``return_carry=True``)."""
    xi = input_product(x, cell.input_weights(x.dtype))
    zeros = torch.zeros(x.shape[0], cell.features, device=x.device)
    carry = (zeros, zeros)
    w_h, b_h = cell.recurrent_weights(zeros.dtype)
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for t in steps:
        carry = cell.step(carry, xi[:, t], w_h, b_h)
    return carry[1]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


class Encoder(nn.Module):
    """Bidirectional LSTM encoder -> (mu, sigma).

    ``dtype`` is the LSTMs' compute dtype (params stay float32); the latent
    heads are float32 and ``sigma`` is softplus. Hierarchical configs
    (``hier_segments > 0``) fold the segments into the batch before the
    BiLSTM and concatenate the per-segment carries, (B, S·2u), into the
    heads.
    """

    def __init__(self, config: MusicVAEConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        S = max(config.hier_segments, 1)
        self.OptimizedLSTMCell_0 = LSTMCell(config.depth, config.enc_units,
                                            dtype)
        self.OptimizedLSTMCell_1 = LSTMCell(config.depth, config.enc_units,
                                            dtype)
        self.mu = Dense(2 * config.enc_units * S, config.latent_dims)
        self.sigma = Dense(2 * config.enc_units * S, config.latent_dims)

    def forward(self, x: torch.Tensor):
        cfg = self.config
        x = x.to(self.dtype)
        B = x.shape[0]
        S = max(cfg.hier_segments, 1)
        if S > 1:
            x = x.reshape(B * S, x.shape[1] // S, x.shape[-1])
        h = torch.cat([_run_lstm(self.OptimizedLSTMCell_0, x),
                       _run_lstm(self.OptimizedLSTMCell_1, x, reverse=True)],
                      dim=-1).float()
        if S > 1:
            h = h.reshape(B, -1)
        return self.mu(h), _softplus(self.sigma(h))


class DecoderCell(nn.Module):
    """One decoder step's layers: the LSTM stack ``lstm_{i}`` over
    ``[token; z]`` and the float32 ``logits`` head."""

    def __init__(self, config: MusicVAEConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = config.depth + config.latent_dims
        for i, u in enumerate(config.dec_units):
            self.add_module(f"lstm_{i}", LSTMCell(width, u, dtype))
            width = u
        self.logits = Dense(width, config.depth)
        self.num_layers = len(config.dec_units)

    def layers(self) -> List[LSTMCell]:
        return [getattr(self, f"lstm_{i}") for i in range(self.num_layers)]


class Decoder(nn.Module):
    """Stacked-LSTM categorical decoder.

    The initial state is ``tanh(z_to_initial_state(z))``, split per layer
    as ``c`` then ``h`` and cast to ``dtype``; the first token is a zero
    one-hot. Teacher forcing (``targets`` given) feeds each target as the
    next step's token and returns the float32 logits (B, L, depth);
    sampling feeds back ``argmax(logits / max(temperature, 1e-6) +
    gumbel)`` (what ``jax.random.categorical`` computes) and returns
    (logits, samples (B, L)). ``gumbel`` (B, L, depth) replaces the draws,
    which otherwise come from ``generator``.

    Scheduled sampling (``ss_prob > 0``, teacher forcing only): after each
    step the next token is, with probability ``ss_prob``, the one-hot of a
    draw from that step's logits at ``temperature`` in place of the target
    (JAX's ``DecoderCell``). ``gumbel`` (B, L, depth) are the draws' Gumbel
    noise and ``ss_mix`` (B, L, 1) the per-step choice: bools (True feeds
    the draw) or uniforms in [0, 1), a draw fed where ``u < ss_prob``, as
    ``jax.random.bernoulli`` decides; what is not given comes from
    ``generator``. A 0-d tensor ``ss_prob`` (a captured training step's)
    always draws, as JAX's scanned step does, whatever its value.
    """

    def __init__(self, config: MusicVAEConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.z_to_initial_state = Dense(config.latent_dims,
                                        2 * sum(config.dec_units))
        self.cell = DecoderCell(config, dtype)

    def _init_carries(self, z):
        init = torch.tanh(self.z_to_initial_state(z))
        carries, offset = [], 0
        for u in self.config.dec_units:
            carries.append((init[:, offset:offset + u].to(self.dtype),
                            init[:, offset + u:offset + 2 * u]
                            .to(self.dtype)))
            offset += 2 * u
        return carries

    def forward(self, z: torch.Tensor, targets: Optional[torch.Tensor] = None,
                temperature: float = 1e-3, length: Optional[int] = None,
                ss_prob: float = 0.0,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None,
                ss_mix: Optional[torch.Tensor] = None):
        cfg = self.config
        B = z.shape[0]
        if length is None:
            length = targets.shape[1] if targets is not None \
                else cfg.max_seq_len
        carries = self._init_carries(z)
        z = z.to(self.dtype)
        token = torch.zeros(B, cfg.depth, dtype=self.dtype, device=z.device)
        layers = self.cell.layers()
        # Every layer's input is in the carries' dtype: ``[token; z]``,
        # then the layer below's ``h``.
        weights = [cell.weights(self.dtype, carry[1].dtype)
                   for cell, carry in zip(layers, carries)]
        # A tensor ss_prob (a captured step's) always takes the
        # scheduled-sampling path: its value is not read on the host.
        scheduled = targets is not None and (torch.is_tensor(ss_prob)
                                             or ss_prob > 0)
        sampled = targets is None or scheduled
        if sampled:
            if gumbel is None:
                gumbel = gumbel_noise((B, length, cfg.depth), generator,
                                      z.device)
            temp = torch.full((), max(float(temperature), 1e-6),
                              dtype=torch.float32, device=z.device)
        if targets is not None:
            targets = targets.to(self.dtype)
            if scheduled:
                if ss_mix is None:
                    ss_mix = torch.rand((B, length, 1), generator=generator,
                                        device=z.device)
                if ss_mix.dtype != torch.bool:
                    ss_mix = ss_mix < torch.as_tensor(ss_prob,
                                                      dtype=torch.float32)
                ss_mix = ss_mix.to(z.device)
        logits, samples = [], []
        for t in range(length):
            x = torch.cat([token, z], dim=-1)
            for i, cell in enumerate(layers):
                w_i, w_h, b_h = weights[i]
                carries[i] = cell.step(carries[i], input_product(x, w_i),
                                       w_h, b_h)
                x = carries[i][1]
            step_logits = self.cell.logits(x.float())
            logits.append(step_logits)
            if sampled:
                idx = torch.argmax(step_logits / temp + gumbel[:, t], dim=-1)
                draw = nn.functional.one_hot(idx, cfg.depth).to(
                    x.dtype if targets is None else targets.dtype)
            if targets is None:
                samples.append(idx)
                token = draw
            elif scheduled:
                token = torch.where(ss_mix[:, t], draw, targets[:, t])
            else:
                token = targets[:, t]
        logits = torch.stack(logits, dim=1)
        if targets is not None:
            return logits
        return logits, torch.stack(samples, dim=1)


class ConductorCell(nn.Module):
    """One conductor step's layers: ``conductor_layers`` LSTMs and the
    projection to a segment embedding (compute dtype: promoted, float32)."""

    def __init__(self, config: MusicVAEConfig):
        super().__init__()
        width = config.latent_dims
        self.num_layers = _conductor_layers(config)
        for i in range(self.num_layers):
            self.add_module(f"lstm_{i}",
                            LSTMCell(width, config.conductor_units))
            width = config.conductor_units
        self.segment_embedding = Dense(width, config.latent_dims)

    def layers(self) -> List[LSTMCell]:
        return [getattr(self, f"lstm_{i}") for i in range(self.num_layers)]


class Conductor(nn.Module):
    """z -> per-segment embeddings (B, hier_segments, latent): the LSTM
    stack rolled out for ``hier_segments`` steps from
    ``tanh(z_to_state(z))``, each step fed the previous embedding (zeros
    first)."""

    def __init__(self, config: MusicVAEConfig):
        super().__init__()
        self.config = config
        u, layers = config.conductor_units, _conductor_layers(config)
        self.z_to_state = Dense(config.latent_dims, 2 * u * layers)
        self.cell = ConductorCell(config)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        u = cfg.conductor_units
        init = torch.tanh(self.z_to_state(z))
        carries = [(init[:, 2 * i * u:(2 * i + 1) * u],
                    init[:, (2 * i + 1) * u:(2 * i + 2) * u])
                   for i in range(self.cell.num_layers)]
        token = torch.zeros(z.shape[0], cfg.latent_dims, dtype=z.dtype,
                            device=z.device)
        layers = self.cell.layers()
        # The inputs after the first step are float32 segment embeddings;
        # float32 kernels give every step the same product dtype.
        weights = [cell.weights(z.dtype, carry[1].dtype)
                   for cell, carry in zip(layers, carries)]
        embeddings = []
        for _ in range(cfg.hier_segments):
            h = token
            for i, cell in enumerate(layers):
                w_i, w_h, b_h = weights[i]
                carries[i] = cell.step(carries[i], input_product(h, w_i),
                                       w_h, b_h)
                h = carries[i][1]
            token = self.cell.segment_embedding(h)
            embeddings.append(token)
        return torch.stack(embeddings, dim=1)


class MusicVAE(nn.Module):
    """``dtype`` = compute dtype for the LSTM stacks (params stay float32;
    the conductor and the heads compute in float32)."""

    def __init__(self, config: MusicVAEConfig = MEL_2BAR_BIG,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = Encoder(config, dtype)
        self.decoder = Decoder(config, dtype)
        if config.hier_segments > 0:
            self.conductor = Conductor(config)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """(z, mu, sigma); z = mu + sigma·noise, ``noise`` standard normal
        from ``generator`` unless given."""
        mu, sigma = self.encoder(x)
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device)
        return mu + sigma * noise, mu, sigma

    def _segments(self, total: int) -> int:
        S = self.config.hier_segments
        if total % S:
            raise ValueError(
                f"Hierarchical decode length {total} must divide by "
                f"hier_segments={S} (it would otherwise silently truncate "
                f"the rollout to {total // S * S} steps)")
        return total // S

    def decode(self, z: torch.Tensor, temperature: float = 1e-3,
               length: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None):
        """(logits, samples). Hierarchical configs fold the segments into
        the batch: one decode of ``length / hier_segments`` steps at batch
        B·S, whose ``gumbel`` is (B·S, length / S, depth)."""
        cfg = self.config
        if cfg.hier_segments > 0:
            S = cfg.hier_segments
            seg_len = self._segments(length or cfg.max_seq_len)
            B = z.shape[0]
            flat = self.conductor(z).reshape(B * S, cfg.latent_dims)
            logits, samples = self.decoder(flat, temperature=temperature,
                                           length=seg_len,
                                           generator=generator,
                                           gumbel=gumbel)
            return (logits.reshape(B, S * seg_len, cfg.depth),
                    samples.reshape(B, S * seg_len))
        return self.decoder(z, temperature=temperature, length=length,
                            generator=generator, gumbel=gumbel)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, ss_prob: float = 0.0,
                gumbel: Optional[torch.Tensor] = None,
                ss_mix: Optional[torch.Tensor] = None):
        """Teacher-forced reconstruction logits and the posterior
        (logits, mu, sigma).

        ``ss_prob``: scheduled sampling, each feedback token replaced with
        that chance by a draw at temperature 1 (see ``Decoder``), whose
        ``gumbel`` and ``ss_mix`` are (B·S, T/S, ·) for hierarchical
        configs. The draws come from ``generator`` after the encoder's
        noise unless given."""
        z, mu, sigma = self.encode(x, generator, noise)
        cfg = self.config
        draws = dict(ss_prob=ss_prob, temperature=1.0, generator=generator,
                     gumbel=gumbel, ss_mix=ss_mix)
        if cfg.hier_segments > 0:
            S = cfg.hier_segments
            B, T, depth = x.shape
            flat = self.conductor(z).reshape(B * S, cfg.latent_dims)
            logits = self.decoder(flat, targets=x.reshape(B * S, T // S,
                                                          depth), **draws)
            logits = logits.reshape(B, T, cfg.depth)
        else:
            logits = self.decoder(z, targets=x, **draws)
        return logits, mu, sigma


def elbo_loss(logits: torch.Tensor, targets: torch.Tensor, mu: torch.Tensor,
              sigma: torch.Tensor, free_bits: float = 0.0, beta: float = 0.2):
    """Negative ELBO: the categorical NLL summed over steps plus beta times
    the KL less the free bits (``free_bits·ln 2`` nats, clipped at 0),
    averaged over the batch. Returns (loss, {"rec", "kl"}), the batch means
    of the NLL and of the whole KL."""
    labels = targets.argmax(-1)
    log_probs = torch.log_softmax(logits, dim=-1)
    rec = -torch.gather(log_probs, -1, labels[..., None]).squeeze(-1).sum(-1)
    var = torch.square(sigma)
    kl = 0.5 * torch.sum(torch.square(mu) + var - 1 - torch.log(var + 1e-12),
                         dim=-1)
    # float32 arithmetic, as jnp.log(2.0) times a weakly typed float.
    free_nats = float(np.float32(free_bits) * np.float32(np.log(2.0)))
    kl_cost = torch.clamp_min(kl - free_nats, 0.0)
    return torch.mean(rec + beta * kl_cost), {"rec": torch.mean(rec),
                                              "kl": torch.mean(kl)}


def build_musicvae(config: MusicVAEConfig, params=None, seed: int = 0,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> MusicVAE:
    """A ``MusicVAE`` on ``device`` with ``params`` (a Flax-layout tree)
    carried in, or with Flax's initializers drawn from ``seed``."""
    from smd_tpu_torch.models.layers import init_parameters
    from smd_tpu_torch.utils.flax_params import load_flax_params
    device = resolve_device(device)
    if params is None:
        model = init_parameters(MusicVAE(config, dtype), seed)
    else:
        # Built without drawing weights, then every one set from the tree.
        with torch.device("meta"):
            model = MusicVAE(config, dtype)
        model = load_flax_params(model.to_empty(device=device), params)
    return model.to(device).eval().requires_grad_(False)


class TrainedMusicVAE:
    """Batched encode/decode over NoteSequences — the TrainedModel analogue.

    ``encode(sequences) -> (z, mu, sigma)``, ``decode(z, temperature,
    length) -> [NoteSequence]``, as in the JAX package; on ``cuda`` unless
    ``device="cpu"``. Built without params, the shapes of a shipped codec
    load it from ``checkpoints/``; without one, the weights are random
    (drawn from ``seed``) and a warning says so. ``{"params", "config"}``
    bundles are taken whole; half-precision leaves are restored to float32.
    """

    def __init__(self, params=None, config: MusicVAEConfig = MEL_2BAR_BIG,
                 converter: Optional[MelodyConverter] = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        device = resolve_device(device)
        # Default-shaped construction without params: shipped codecs. Only
        # full-size configs auto-load (a deliberately tiny test config must
        # keep its requested architecture with random weights).
        if params is None and config == MEL_2BAR_BIG:
            params = load_default_melody_params()
            if params is not None:
                log.info("Loaded shipped melody codec (%s)",
                         "cat-mel_2bar_big" if
                         os.path.exists(DEFAULT_MELODY_BIG_ARTIFACT)
                         else DEFAULT_MELODY_ARTIFACT)
        elif params is None and config.hier_segments > 0 and \
                config.latent_dims == 512 and config.enc_units >= 1024 and \
                config.depth == 90:
            params = load_default_melody16_params()
            if params is not None:
                log.info("Loaded shipped 16-bar hierdec melody codec from "
                         "%s", DEFAULT_MELODY16_ARTIFACT)
        elif params is None and config.hier_segments > 0 and \
                config.latent_dims == 512 and config.enc_units >= 1024:
            params = load_default_multi_params()
            if params is not None and \
                    params["config"].depth != config.depth:
                params = None   # different event vocabulary: no fit
            if params is not None:
                log.info("Loaded shipped multitrack codec from %s",
                         DEFAULT_MULTI_ARTIFACT)
        if isinstance(params, dict) and {"params", "config"} <= set(params):
            config = normalize_config(params["config"])
            params = normalize_params(params["params"])
        self.config = config
        if converter is None:
            # Infer from the (possibly bundle-supplied) config shape: the
            # hier-multiperf event vocabulary means the performance
            # converter; a melody-vocab codec over longer chunks matches
            # slice_bars to its sequence length; else the 2-bar grid.
            from smd_tpu_torch.codec.performance import (
                multiperf_default_1bar_converter)
            if config.hier_segments > 0 and \
                    config.depth == multiperf_default_1bar_converter.depth:
                converter = multiperf_default_1bar_converter
            elif config.max_seq_len != 32 and config.max_seq_len % 16 == 0:
                converter = MelodyConverter(
                    steps_per_quarter=4, slice_bars=config.max_seq_len // 16)
            else:
                converter = melody_2bar_converter
        self.converter = converter
        self.random_weights = params is None
        if params is None:
            log.warning(
                "TrainedMusicVAE constructed WITHOUT trained parameters: "
                "encode/decode run with random weights, so decoded MIDI is "
                "musically meaningless. Pass a trained codec's params "
                "bundle (the reference's capability assumes a pretrained "
                "MusicVAE, reference config.py:17-19).")
        self.device = device
        self.model = build_musicvae(config, params, seed, compute_dtype,
                                    device)
        self._generator = torch.Generator(device=device).manual_seed(seed + 1)

    @property
    def latent_dims(self):
        return self.config.latent_dims

    def encode_tensors(self, tensors):
        """(z, mu, sigma) float32 numpy of a list of one-hot chunks."""
        x = torch.from_numpy(np.stack(tensors).astype(np.float32))
        with torch.no_grad():
            out = self.model.encode(x.to(self.device), self._generator)
        return tuple(t.cpu().numpy() for t in out)

    def encode(self, sequences: Sequence) -> Tuple[np.ndarray, ...]:
        tensors = []
        for ns in sequences:
            inputs = self.converter.to_tensors(ns).inputs
            if not inputs:
                raise ValueError("Cannot encode an empty sequence")
            tensors.append(inputs[0])
        return self.encode_tensors(tensors)

    def decode_to_tensors(self, z, temperature=1e-3, gumbel=None):
        """Sampled tokens (B, max_seq_len) int32 of latents ``z``."""
        z = torch.tensor(np.asarray(z, np.float32), device=self.device)
        with torch.no_grad():
            _, samples = self.model.decode(z, float(temperature),
                                           generator=self._generator,
                                           gumbel=gumbel)
        return samples.cpu().numpy().astype(np.int32)

    def decode(self, z, temperature=1e-3, length=None) -> List:
        """NoteSequences of latents ``z``; ``length`` is ignored, as in the
        JAX package (the codec decodes ``max_seq_len`` steps)."""
        del length
        return self.converter.from_tensors(
            self.decode_to_tensors(z, temperature))
