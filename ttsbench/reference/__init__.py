"""Plain references the benchmark judges the port by.

Plain PyTorch in float32 (TF32 off), written from the published
descriptions: a pre-norm GQA decoder (RMSNorm, SwiGLU, rotary positions,
no biases) and the SNAC 24 kHz decoder with position-addressed noise. They
import nothing of the port and take only what the benchmark made: the
weights, the texts and the port's outputs, which they judge.
"""
