"""The MusicVAE codec and its host-side music layer (port of
``smd_tpu/codec/``): NoteSequences, Standard MIDI File I/O, the melody,
performance and grid converters, the ``song`` helpers (numpy copies of the
JAX package's modules), and ``musicvae``, the codec in PyTorch. ``synth``
(audio) is not ported yet: see ``ROADMAP.md``, queue A, item 10, part 7."""
