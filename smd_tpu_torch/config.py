"""Named MusicVAE configurations (port of ``smd_tpu/config.py``; reference
``config.py:21-93``).

Registry keys match the reference: ``melody-2-big``, ``melody-16-big``,
``multi-1-big``, ``multi-0min-1-big``, ``melody-2-big-nopoly``. Each entry
pairs a data converter with a MusicVAE architecture config.
"""
from __future__ import annotations

import dataclasses

from smd_tpu_torch.codec.melody import MelodyConverter
from smd_tpu_torch.codec.musicvae import MusicVAEConfig
from smd_tpu_torch.codec.performance import (multiperf_default_1bar_converter,
                                       multiperf_zero_1bar_converter)

__all__ = ["MUSIC_VAE_CONFIG", "melody_2bar_converter",
           "mel_2bar_nopoly_converter", "melody_16bar_converter"]

melody_2bar_converter = MelodyConverter(steps_per_quarter=4, slice_bars=2)
# Magenta's nopoly variant *skips* polyphonic segments (reference
# config.py:32-39) rather than reducing them to the highest note.
mel_2bar_nopoly_converter = MelodyConverter(steps_per_quarter=4, slice_bars=2,
                                            skip_polyphony=True)
melody_16bar_converter = MelodyConverter(steps_per_quarter=4, slice_bars=16)


@dataclasses.dataclass(frozen=True)
class VAEConfigEntry:
    model: MusicVAEConfig
    data_converter: object


MUSIC_VAE_CONFIG = {
    "melody-2-big": VAEConfigEntry(
        MusicVAEConfig(latent_dims=512, enc_units=2048,
                       dec_units=(2048, 2048, 2048), depth=90,
                       max_seq_len=32),
        melody_2bar_converter),
    # Hierarchical configs (Magenta's hierdec-mel_16bar and
    # hier-multiperf_vel_1bar_big analogues): a conductor RNN expands z into
    # per-bar embeddings decoded by the shared core decoder.
    "melody-16-big": VAEConfigEntry(
        MusicVAEConfig(latent_dims=512, enc_units=2048,
                       dec_units=(2048, 2048, 2048), depth=90,
                       max_seq_len=256, hier_segments=16),
        melody_16bar_converter),
    # hier-multiperf_vel_1bar_big analogue: per-instrument performance-event
    # streams (8 instruments x 64 events, velocity bins); the conductor
    # expands z into one embedding per instrument stream.
    "multi-1-big": VAEConfigEntry(
        MusicVAEConfig(latent_dims=512, enc_units=2048,
                       dec_units=(1024, 1024),
                       depth=multiperf_default_1bar_converter.depth,
                       max_seq_len=multiperf_default_1bar_converter.seq_len,
                       hier_segments=8),
        multiperf_default_1bar_converter),
    "multi-0min-1-big": VAEConfigEntry(
        MusicVAEConfig(latent_dims=512, enc_units=2048,
                       dec_units=(1024, 1024),
                       depth=multiperf_zero_1bar_converter.depth,
                       max_seq_len=multiperf_zero_1bar_converter.seq_len,
                       hier_segments=8),
        multiperf_zero_1bar_converter),
    "melody-2-big-nopoly": VAEConfigEntry(
        MusicVAEConfig(latent_dims=512, enc_units=2048,
                       dec_units=(2048, 2048, 2048), depth=90,
                       max_seq_len=32),
        mel_2bar_nopoly_converter),
}
