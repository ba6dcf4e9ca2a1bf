"""The MusicVAE codec and its host-side music layer (port of
``smd_tpu/codec/``): NoteSequences, Standard MIDI File I/O, the melody,
performance and grid converters, the ``song`` helpers (numpy copies of the
JAX package's modules), ``musicvae``, the codec in PyTorch, and ``synth``,
audio through the native renderer ``native/smd_synth.cpp``."""
