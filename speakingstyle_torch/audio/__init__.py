"""Wav IO and log-mel extraction."""
