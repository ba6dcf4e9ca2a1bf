"""smd_tpu_torch — the PyTorch and CUDA port of ``smd_tpu`` for an NVIDIA H100.

The JAX package ``smd_tpu`` stays the reference; every module here keeps its
counterpart's path and names (``smd_tpu_torch/models/ddpm.py`` ports
``smd_tpu/models/ddpm.py``) and is held against it by ``tests/test_torch_*.py``.
Nothing here imports JAX or ``smd_tpu``: where the port needs a function of
the JAX package, even a numpy-only one, it keeps its own copy.

Entry points (``models.get_model``, ``sampling.generate.sample``,
``codec.musicvae.TrainedMusicVAE``, ``python -m smd_tpu_torch.train_ncsn``,
``python -m smd_tpu_torch.sample_ncsn``, the ``scripts``) run on ``cuda``
unless the caller passes ``device="cpu"`` (``--device=cpu``); without a GPU
and without that request they raise (``device.resolve_device``). Each
Pallas kernel of the JAX package is a CUDA C++ kernel under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``) and called
through ``ctypes``; on a CPU tensor its wrapper takes the plain PyTorch
version that sits beside it.

Subpackages
-----------
- ``smd_tpu_torch.codec``: the MusicVAE codec (encoder, decoder, conductor,
  ``TrainedMusicVAE``) and the MIDI, NoteSequence, converter and song
  helpers around it; ``smd_tpu_torch.config`` names its configurations.
- ``smd_tpu_torch.data``: the TF-free TFRecord writer, reader and input
  pipeline, and numpy copies of the latent transforms.
- ``smd_tpu_torch.diffusion``: noise schedules, the DDPM loss, denoising and
  sliced score matching, the annealed and consistent Langevin samplers, the
  DDPM, DDIM, DPM-Solver++, distilled and consistency samplers, the replay
  buffer.
- ``smd_tpu_torch.models``: TransformerDDPM in the standard and fused layouts
  and with the int8 serving head; DenseDDPM, DenseNCSN, ConvNCSN, ToyDDPM
  and ToyNCSN.
- ``smd_tpu_torch.ops``: kernel wrappers, their plain versions, the build.
- ``smd_tpu_torch.sampling``: the generation drivers (sampling, infilling,
  interpolation).
- ``smd_tpu_torch.training``: the optimizer, train state, train step and
  loop; progressive and consistency distillation.
- ``smd_tpu_torch.utils``: the Flax params tree <-> module weight carrier,
  checkpoints, the pickle loader of the JAX package's bundles, logging,
  op profiles, the reader of flax's msgpack checkpoints and the
  reference-checkpoint converter.
- ``smd_tpu_torch.scripts``: the dataset scripts (``transform_encoded_data``,
  ``generate_compressed_transform``) and the codec scripts
  (``generate_song_data``, ``decode_dataset``,
  ``package_generation_bundle``, ``generate_melodies``), and
  ``convert_reference_checkpoint``.
- ``smd_tpu_torch.parallel``: process groups on a (data, model) grid, the
  split rules and column-parallel Dense layers; ``smd_tpu_torch.dryrun``
  runs one train step across spawned ranks.
- ``smd_tpu_torch.cli``, ``smd_tpu_torch.train_ncsn``,
  ``smd_tpu_torch.sample_ncsn``: the flags (parsed without absl) and the
  training (and distillation) and sampling entry points.
"""

__version__ = "0.1.0"
