"""Model pieces of the port: ViT, resampler, gated xattn, GPT-2, OPT, assembly."""
