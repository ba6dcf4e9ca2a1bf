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

Each LSTM cell computes what ``flax.linen.OptimizedLSTMCell`` computes.

The recurrences. JAX scans the encoder's two LSTMs (``nn.RNN``), the
decoder and the conductor (``nn.scan``) inside one jitted program. Here
each is one step body over per-call buffers, run through a kept chain of
``utils/graphs.py`` (``group="codec"``): the carries, the fed-back token
and each step's outputs (a row of logits and of samples, a segment
embedding) are written in place at the row the chain's device index
names, each step's inputs (the encoder's input products, the decoder's
Gumbel draws, targets and scheduled-sampling choices) are staged as the
chain's per-step rows, and the temperature is a 0-d tensor staged each
call. On the card the step is captured in a CUDA graph and replayed once a
step; on the CPU (and under ``graphs.eager()``) the same body runs eagerly.
A call with autograd on (an eager training step) or inside an enclosing
capture (a captured training step, ``training/graphs.py``) runs the steps
inline instead, the same per-step arithmetic: the outer graph or autograd
needs them there. A kept chain holds the gate kernels joined side by side
in buffers of its own, rewritten from the parameters before each call
(``refresh``), so its graph reads the weights as they are at the call,
however they were written since (a captured optimizer step moves no
version counter); a parameter rebound since the capture makes a new
chain.

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
from smd_tpu_torch.utils import graphs

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


def _chained(t: torch.Tensor) -> bool:
    """Whether a recurrence on ``t`` runs as a chain: with autograd off and
    outside any capture (an enclosing graph or autograd needs the steps
    inline)."""
    if torch.is_grad_enabled():
        return False
    return not (t.is_cuda and torch.cuda.is_current_stream_capturing())


def _joined(weights):
    """(kernels, refresh) for a chain's step body: ``weights()`` gives each
    cell's gate kernels joined side by side and cast (a list of tuples, new
    tensors); the step reads the first call's, and ``refresh()`` rewrites
    them in place from the parameters."""
    kernels = weights()

    def refresh():
        torch._foreach_copy_([t for group in kernels for t in group],
                             [t for group in weights() for t in group])

    return kernels, refresh


def _stack_step(layers, weights, carries, x):
    """One step of an LSTM stack on ``x``: each layer advanced on the one
    below's ``h``. Returns (the new carries, the top ``h``)."""
    new = []
    for cell, (w_i, w_h, b_h), carry in zip(layers, weights, carries):
        carry = cell.step(carry, input_product(x, w_i), w_h, b_h)
        new.append(carry)
        x = carry[1]
    return new, x


def _write_carries(s, carries):
    for j, (c, h) in enumerate(carries):
        s[f"c{j}"].copy_(c)
        s[f"h{j}"].copy_(h)


def _read_carries(s, layers: int):
    return [(s[f"c{j}"], s[f"h{j}"]) for j in range(layers)]


def _carry_buffers(carries) -> dict:
    out = {}
    for j, (c, h) in enumerate(carries):
        out[f"c{j}"], out[f"h{j}"] = c, h
    return out


def _bilstm_products(cells: Sequence[LSTMCell], x: torch.Tensor):
    """The input products of the forward and the backward LSTM over ``x``
    (B, T, in), each (T, B, 4u) in the order its LSTM reads them: row t is
    input t for the forward one, input T-1-t for the backward one."""
    xt = x.transpose(0, 1)
    return (input_product(xt, cells[0].input_weights(x.dtype)),
            input_product(xt.flip(0), cells[1].input_weights(x.dtype)))


def _bilstm_step(cells):
    """The encoder's step body: the forward carry (``c0``, ``h0``) advanced
    on the step's ``xf``, the backward one (``c1``, ``h1``) on its ``xb``,
    in place."""
    weights, refresh = _joined(lambda: [
        cell.recurrent_weights(torch.float32) for cell in cells])

    def step(s):
        _write_carries(s, [
            cell.step(carry, s[name], *w) for cell, carry, name, w in zip(
                cells, _read_carries(s, 2), ("xf", "xb"), weights)])
        return {}
    step.refresh = refresh
    return step


def _run_bilstm(encoder: nn.Module, cells: Sequence[LSTMCell],
                x: torch.Tensor):
    """The final carries' ``h`` of the forward and the backward LSTM over
    ``x`` (B, T, in), each from a zero float32 carry (``nn.RNN`` with
    ``return_carry=True``; the backward one with ``reverse=True``)."""
    xf, xb = _bilstm_products(cells, x)
    shape = (x.shape[0], cells[0].features)
    if _chained(x):
        zero = graphs.zeros(shape, device=x.device)
        run = graphs.chain("encoder", encoder, (), x.device,
                           lambda gen: _bilstm_step(cells), group="codec")
        bufs, _ = run(None, {"xf": xf, "xb": xb}, {},
                      _carry_buffers([(zero, zero)] * 2), None)
        return bufs["h0"].clone(), bufs["h1"].clone()
    zero = torch.zeros(shape, device=x.device)
    carries = [(zero, zero)] * 2
    weights = [cell.recurrent_weights(zero.dtype) for cell in cells]
    for t in range(xf.shape[0]):
        carries = [cell.step(carry, xi[t], *w) for cell, carry, xi, w in
                   zip(cells, carries, (xf, xb), weights)]
    return carries[0][1], carries[1][1]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


class Encoder(nn.Module):
    """Bidirectional LSTM encoder -> (mu, sigma).

    The two LSTMs advance together, one step body (see the module's
    docstring); their input products are taken for every step at once
    before the steps. ``dtype`` is the LSTMs' compute dtype (params stay
    float32); the latent heads are float32 and ``sigma`` is softplus.
    Hierarchical configs (``hier_segments > 0``) fold the segments into the
    batch before the BiLSTM and concatenate the per-segment carries,
    (B, S·2u), into the heads.
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
        h = torch.cat(_run_bilstm(self, (self.OptimizedLSTMCell_0,
                                         self.OptimizedLSTMCell_1), x),
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

    The steps run as the kept chain of their mode (free-running,
    teacher-forced, scheduled sampling; see the module's docstring): every
    draw is made before step 0, as one (B, L, ·) draw each, and staged as
    the chain's per-step rows, so the generator ends where the inline steps
    leave it.
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
        # A tensor ss_prob (a captured step's) always takes the
        # scheduled-sampling path: its value is not read on the host.
        scheduled = targets is not None and (torch.is_tensor(ss_prob)
                                             or ss_prob > 0)
        mode = "free" if targets is None else \
            "scheduled" if scheduled else "teacher"
        # Each step's inputs, (B, length, ...) stacks.
        per_step, temp = {}, None
        if mode != "teacher":
            if gumbel is None:
                gumbel = gumbel_noise((B, length, cfg.depth), generator,
                                      z.device)
            per_step["gumbel"] = _checked("gumbel", gumbel,
                                          (B, length, cfg.depth))
            temp = torch.full((), max(float(temperature), 1e-6),
                              dtype=torch.float32, device=z.device)
        if targets is not None:
            per_step["target"] = _checked(
                "targets", targets, (B, length, cfg.depth)).to(self.dtype)
            if scheduled:
                if ss_mix is None:
                    ss_mix = torch.rand((B, length, 1), generator=generator,
                                        device=z.device)
                if ss_mix.dtype != torch.bool:
                    ss_mix = ss_mix < torch.as_tensor(ss_prob,
                                                      dtype=torch.float32)
                per_step["mix"] = _checked("ss_mix", ss_mix.to(z.device),
                                           (B, length, 1))
        if _chained(z):
            return self._chain(mode, carries, z, temp, per_step, length)
        token = torch.zeros(B, cfg.depth, dtype=self.dtype, device=z.device)
        layers = self.cell.layers()
        # Every layer's input is in the carries' dtype: ``[token; z]``,
        # then the layer below's ``h``.
        weights = [cell.weights(self.dtype, carry[1].dtype)
                   for cell, carry in zip(layers, carries)]
        logits, samples = [], []
        for t in range(length):
            carries, x = _stack_step(layers, weights, carries,
                                     torch.cat([token, z], dim=-1))
            step_logits = self.cell.logits(x.float())
            logits.append(step_logits)
            token, idx = _feedback(mode, step_logits, temp,
                                   {n: v[:, t] for n, v in per_step.items()},
                                   self.dtype)
            samples.append(idx)
        logits = torch.stack(logits, dim=1)
        if targets is not None:
            return logits
        return logits, torch.stack(samples, dim=1)

    def _chain(self, mode, carries, z, temp, per_step, length):
        """The decode through the kept chain of ``mode``."""
        B, depth, device = z.shape[0], self.config.depth, z.device
        statics = {"z": z, "token": graphs.zeros((B, depth), self.dtype,
                                                 device),
                   "logits": graphs.zeros((B, length, depth),
                                          device=device),
                   **_carry_buffers(carries)}
        if mode != "teacher":
            statics["temp"] = temp
        if mode == "free":
            statics["samples"] = graphs.zeros((B, length), torch.long,
                                              device)
        run = graphs.chain(f"{mode} decoder", self, (mode, self.dtype),
                           device, lambda gen: _decoder_step(self, mode),
                           group="codec")
        bufs, _ = run(None, {n: v.transpose(0, 1)
                             for n, v in per_step.items()}, {}, statics,
                      None)
        logits = bufs["logits"].clone()
        if mode == "free":
            return logits, bufs["samples"].clone()
        return logits


def _checked(name: str, value: torch.Tensor, shape) -> torch.Tensor:
    """``value``, raising unless it has ``shape``."""
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"the codec's decoder takes {name} of shape "
                         f"{tuple(shape)}, not {tuple(value.shape)}")
    return value


def _feedback(mode: str, logits: torch.Tensor, temp, inputs, dtype):
    """(the next step's token in ``dtype``, the sampled index or None)
    after a step's ``logits``, from the step's ``inputs``: the target
    (teacher forcing); ``argmax(logits / temp + gumbel)`` as a one-hot
    (free-running, what ``jax.random.categorical`` draws); or that draw
    where the step's ``mix`` says so, else the target (scheduled
    sampling)."""
    if mode == "teacher":
        return inputs["target"], None
    idx = torch.argmax(logits / temp + inputs["gumbel"], dim=-1)
    draw = nn.functional.one_hot(idx, logits.shape[-1]).to(dtype)
    if mode == "free":
        return draw, idx
    return torch.where(inputs["mix"], draw, inputs["target"]), idx


def _decoder_step(decoder: Decoder, mode: str):
    """The decoder's step body: ``[token; z]`` through the LSTM stack to
    float32 logits, written at the step's row; the next token chosen by
    ``_feedback`` and written in place, the sampled index at its row
    (free-running)."""
    layers = decoder.cell.layers()
    weights, refresh = _joined(lambda: [
        cell.weights(decoder.dtype, decoder.dtype) for cell in layers])

    def step(s):
        i, token = s["step"], s["token"]
        carries, x = _stack_step(layers, weights,
                                 _read_carries(s, len(layers)),
                                 torch.cat([token, s["z"]], dim=-1))
        _write_carries(s, carries)
        logits = decoder.cell.logits(x.float())
        s["logits"].index_copy_(1, i, logits.unsqueeze(1))
        new, idx = _feedback(mode, logits, s.get("temp"), s, decoder.dtype)
        token.copy_(new)
        if mode == "free":
            s["samples"].index_copy_(1, i, idx.unsqueeze(1))
        return {}
    step.refresh = refresh
    return step


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
        shape = (z.shape[0], cfg.latent_dims)
        if _chained(z):
            statics = {"token": graphs.zeros(shape, z.dtype, z.device),
                       "emb": graphs.zeros((shape[0], cfg.hier_segments,
                                            shape[1]), device=z.device),
                       **_carry_buffers(carries)}
            dtypes = (z.dtype, init.dtype)
            run = graphs.chain("conductor", self, dtypes, z.device,
                               lambda gen: _conductor_step(self, *dtypes),
                               group="codec")
            bufs, _ = run(None, {}, {}, statics,
                          [None] * cfg.hier_segments)
            return bufs["emb"].clone()
        token = torch.zeros(shape, dtype=z.dtype, device=z.device)
        layers = self.cell.layers()
        weights = _conductor_weights(self, z.dtype, init.dtype)
        embeddings = []
        for _ in range(cfg.hier_segments):
            carries, h = _stack_step(layers, weights, carries, token)
            token = self.cell.segment_embedding(h)
            embeddings.append(token)
        return torch.stack(embeddings, dim=1)


def _conductor_weights(conductor: Conductor, z_dtype, carry_dtype):
    # The inputs after the first step are float32 segment embeddings;
    # float32 kernels give every step the same product dtype.
    return [cell.weights(z_dtype, carry_dtype)
            for cell in conductor.cell.layers()]


def _conductor_step(conductor: Conductor, z_dtype, carry_dtype):
    """The conductor's step body: the previous embedding through the LSTM
    stack to the next segment embedding, written at the step's row and fed
    back in place."""
    layers = conductor.cell.layers()
    weights, refresh = _joined(lambda: _conductor_weights(
        conductor, z_dtype, carry_dtype))

    def step(s):
        carries, h = _stack_step(layers, weights,
                                 _read_carries(s, len(layers)), s["token"])
        _write_carries(s, carries)
        token = conductor.cell.segment_embedding(h)
        s["emb"].index_copy_(1, s["step"], token.unsqueeze(1))
        s["token"].copy_(token)
        return {}
    step.refresh = refresh
    return step


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

    @staticmethod
    def _bucket(n: int) -> int:
        """``n`` rounded up to a power of two (JAX's ``_bucket``)."""
        b = 1
        while b < n:
            b *= 2
        return b

    def encode_tensors(self, tensors):
        """(z, mu, sigma) float32 numpy of a list of one-hot chunks. The
        batch is padded with zero chunks to a power of two and the rows
        sliced back, as in the JAX package, so songs of any length reuse
        O(log N) captured encoder chains; the noise is drawn for the padded
        batch, as JAX draws it."""
        n = len(tensors)
        x = np.stack(tensors).astype(np.float32)
        x = np.concatenate([x, np.zeros((self._bucket(n) - n, *x.shape[1:]),
                                        np.float32)])
        with torch.no_grad():
            out = self.model.encode(torch.from_numpy(x).to(self.device),
                                    self._generator)
        return tuple(t[:n].cpu().numpy() for t in out)

    def encode(self, sequences: Sequence) -> Tuple[np.ndarray, ...]:
        tensors = []
        for ns in sequences:
            inputs = self.converter.to_tensors(ns).inputs
            if not inputs:
                raise ValueError("Cannot encode an empty sequence")
            tensors.append(inputs[0])
        return self.encode_tensors(tensors)

    def decode_to_tensors(self, z, temperature=1e-3, gumbel=None):
        """Sampled tokens (B, max_seq_len) int32 of latents ``z``.

        The Gumbel draws (``gumbel``, else drawn from the codec's generator)
        are those of the B rows, as an unpadded decode makes them; the
        latents and the draws are then padded with zero rows to a power of
        two and the tokens sliced back, so decodes of any batch reuse
        O(log N) captured decoder chains. (The JAX package pads only the
        encode; each row's tokens are the same.)"""
        cfg = self.config
        z = torch.tensor(np.asarray(z, np.float32), device=self.device)
        n = z.shape[0]
        S = max(cfg.hier_segments, 1)
        if gumbel is None:
            gumbel = gumbel_noise((n * S, cfg.max_seq_len // S, cfg.depth),
                                  self._generator, self.device)
        gumbel = torch.as_tensor(gumbel, device=self.device)
        pad = self._bucket(n) - n
        z = torch.cat([z, z.new_zeros((pad, z.shape[1]))])
        gumbel = torch.cat([gumbel, gumbel.new_zeros(
            (pad * S, *gumbel.shape[1:]))])
        with torch.no_grad():
            _, samples = self.model.decode(z, float(temperature),
                                           gumbel=gumbel)
        return samples[:n].cpu().numpy().astype(np.int32)

    def decode(self, z, temperature=1e-3, length=None) -> List:
        """NoteSequences of latents ``z``; ``length`` is ignored, as in the
        JAX package (the codec decodes ``max_seq_len`` steps)."""
        del length
        return self.converter.from_tensors(
            self.decode_to_tensors(z, temperature))
