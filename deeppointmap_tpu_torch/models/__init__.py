"""Encoder and decoder as torch modules, and the weight reader."""
