"""Scripts of the port, run as ``python -m smd_tpu_torch.scripts.<name>``:
the dataset scripts ``transform_encoded_data`` and
``generate_compressed_transform``; the codec scripts ``generate_song_data``
(MIDI -> latent records), ``decode_dataset`` (latent records -> token
records), ``package_generation_bundle`` (a trained model_dir -> a
generation bundle in the JAX package's format) and ``generate_melodies``
(a bundle -> MIDI files); codec training and evaluation,
``train_musicvae`` and ``eval_codec``; ``sample_audio`` (latent pickles ->
MIDI, WAV and piano rolls); and the synthetic corpora,
``make_melody_corpus`` and ``make_multitrack_corpus``."""
