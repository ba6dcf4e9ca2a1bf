"""Evaluation: sampling metrics, MIDI metrics and plots."""
