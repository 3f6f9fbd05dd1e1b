"""Data: synthetic pose sampler, depth noise, synthetic batch generator."""
