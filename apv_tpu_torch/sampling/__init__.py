"""Sampling: SIR/MALA from the shaped prior, ex-post priors, decoding and
image grids."""

from apv_tpu_torch.sampling.run import (decoder_pixels, generate_samples,
                                        latent_interpolate,
                                        reconstruct_images, sample_prior,
                                        save_image_grid)

__all__ = ["decoder_pixels", "generate_samples", "latent_interpolate",
           "reconstruct_images", "sample_prior", "save_image_grid"]
