"""Full-granule encode/decode at /64 spatial sizes; counterpart of
tempo_tpu/infer/granule_codec.py.

Normalize exactly as training, crop H and W down to multiples of the tile
size, run ONE forward over the whole granule (e.g. [1, 128, 2048, 1028])
and return the reconstruction and/or the posterior-mean latent on the
4x-downsampled grid. The raw granule is copied to the codec's device once
and normalized and cropped there (``normalize_tensor``); ``encode``,
``decode_tensor`` and ``reconstruct`` take that tensor as it is. Everything
runs under torch.inference_mode(). The JAX package's ``mesh`` (spatial
sharding over several chips) is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from tempo_tpu_torch.data.normalize import normalize_radiance
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.models.vae import AutoencoderKL
from tempo_tpu_torch.nn.distributions import DiagonalGaussian


def crop_to_multiple(arr, multiple: int = 64):
    """[mirror, track, spectral] (numpy or tensor) -> cropped so
    mirror/track % multiple == 0."""
    h = (arr.shape[0] // multiple) * multiple
    w = (arr.shape[1] // multiple) * multiple
    return arr[:h, :w]


class GranuleCodec:
    """Whole-granule encoder/decoder around a trained AutoencoderKL, on
    ``device`` (None means CUDA). Posterior samples come from a
    torch.Generator seeded with ``seed``."""

    def __init__(self, model: AutoencoderKL,
                 mean_spectrum: Optional[np.ndarray] = None,
                 std_spectrum: Optional[np.ndarray] = None,
                 multiple: int = 64, seed: int = 42, shape_bucket: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mean_spectrum = mean_spectrum
        self.std_spectrum = std_spectrum
        self._spectra = [None if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=self.device)
            for a in (mean_spectrum, std_spectrum)]
        self.multiple = multiple * shape_bucket
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _put(self, arr: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """[H, W, C] -> [1, H, W, C] on the codec's device."""
        if not isinstance(arr, torch.Tensor):
            arr = np.ascontiguousarray(arr)
            # torch.from_numpy wants a writable array (JAX hands out
            # read-only views); copy only then.
            arr = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        return arr.to(self.device)[None]

    @torch.inference_mode()
    def normalize_tensor(self, rad: Union[np.ndarray, torch.Tensor]
                         ) -> torch.Tensor:
        """Training-equivalent normalization + /multiple crop on the
        codec's device: raw [mirror, track, spectral] -> [H, W, C] fp32."""
        z = normalize_radiance(self._put(rad)[0], *self._spectra)
        return crop_to_multiple(z, self.multiple).contiguous()

    def normalize(self, rad: np.ndarray) -> np.ndarray:
        """``normalize_tensor`` as a host array."""
        return self.normalize_tensor(rad).cpu().numpy()

    @torch.inference_mode()
    def encode(self, granule_hwc: Union[np.ndarray, torch.Tensor]
               ) -> torch.Tensor:
        """Normalized [H, W, C] -> posterior MEAN latent [H/4, W/4, Z]."""
        return self.model.encode(self._put(granule_hwc)).mean[0]

    @torch.inference_mode()
    def encode_posterior(self, granule_hwc: np.ndarray) -> DiagonalGaussian:
        return self.model.encode(self._put(granule_hwc))

    @torch.inference_mode()
    def decode_tensor(self, latent_hwc: Union[np.ndarray, torch.Tensor]
                      ) -> torch.Tensor:
        """Latent [h, w, Z] -> reconstruction [H, W, C] on the codec's
        device, in the model's compute dtype."""
        return self.model.decode(self._put(latent_hwc))[0]

    def decode(self, latent_hwc: Union[np.ndarray, torch.Tensor]
               ) -> np.ndarray:
        """Latent [h, w, Z] -> reconstruction [H, W, C] as fp32 numpy."""
        return self.decode_tensor(latent_hwc).float().cpu().numpy()

    @torch.inference_mode()
    def reconstruct(self, granule_hwc: Union[np.ndarray, torch.Tensor],
                    sample_posterior: bool = True) -> np.ndarray:
        """Normalized [H, W, C] -> single-forward reconstruction [H, W, C]."""
        out = self.model.reconstruct(self._put(granule_hwc),
                                     generator=self.generator,
                                     sample_posterior=sample_posterior)
        return out[0].float().cpu().numpy()

    def reconstruct_raw(self, rad: np.ndarray, sample_posterior: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Raw radiance [mirror, track, spectral] -> (normalized GT crop,
        reconstruction), both [H, W, C] host arrays; the normalized crop
        goes to the model without leaving the device."""
        gt = self.normalize_tensor(rad)
        return gt.cpu().numpy(), self.reconstruct(gt, sample_posterior)
