"""Full-granule encode/decode at /64 spatial sizes; counterpart of
tempo_tpu/infer/granule_codec.py.

Normalize exactly as training, crop H and W down to multiples of the tile
size, run ONE forward over the whole granule (e.g. [1, 128, 2048, 1028])
and return the reconstruction and/or the posterior-mean latent on the
4x-downsampled grid. The raw granule is copied to the codec's device once
and normalized and cropped there (``normalize_tensor``); ``encode``,
``decode_tensor`` and ``reconstruct`` take that tensor as it is. Everything
runs under torch.inference_mode().

With a ``mesh`` (parallel/mesh.py ``create_mesh`` over the process group)
every forward is split along W, the track axis, over the ranks
(parallel/spatial.py: conv halos, GroupNorm sums over the ranks, the mid
attention's K/V gathered). The whole granule may sit in host memory on
every rank; a rank copies only its W share to its device, which never
holds the whole granule. A tensor on the codec's device is then this
rank's share (what ``normalize_tensor``, ``encode`` and ``decode_tensor``
return); a host array, or a tensor elsewhere, is the whole array, of which
the rank takes its share. ``to_host`` assembles the whole array of a share
on the host, as JAX's ``np.asarray`` of a sharded array does; ``decode``,
``reconstruct`` and ``reconstruct_raw`` return whole host arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from tempo_tpu_torch.data.normalize import normalize_radiance
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.models.vae import AutoencoderKL
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.parallel import spatial


def crop_to_multiple(arr, multiple: int = 64):
    """[mirror, track, spectral] (numpy or tensor) -> cropped so
    mirror/track % multiple == 0."""
    h = (arr.shape[0] // multiple) * multiple
    w = (arr.shape[1] // multiple) * multiple
    return arr[:h, :w]


class GranuleCodec:
    """Whole-granule encoder/decoder around a trained AutoencoderKL, on
    ``device`` (None means CUDA). Posterior samples come from a
    torch.Generator seeded with ``seed``. ``mesh``: split every forward
    along W over the mesh's ranks (module doc)."""

    def __init__(self, model: AutoencoderKL,
                 mean_spectrum: Optional[np.ndarray] = None,
                 std_spectrum: Optional[np.ndarray] = None,
                 multiple: int = 64, seed: int = 42, shape_bucket: int = 1,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mean_spectrum = mean_spectrum
        self.std_spectrum = std_spectrum
        self._spectra = [None if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=self.device)
            for a in (mean_spectrum, std_spectrum)]
        self.multiple = multiple * shape_bucket
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sharding = None if mesh is None else spatial.spatial_sharding(
            mesh)
        self.stride = model.config.spatial_factor

    def _put(self, arr: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """[H, W, C] -> [1, H, W, C] on the codec's device."""
        if not isinstance(arr, torch.Tensor):
            arr = np.ascontiguousarray(arr)
            # torch.from_numpy wants a writable array (JAX hands out
            # read-only views); copy only then.
            arr = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        return arr.to(self.device)[None]

    def _share(self, arr, stride: int) -> Tuple[torch.Tensor, list]:
        """With a mesh: ([1, H, w, C] this rank's share on the device, every
        rank's width); ``arr`` is the share where it is a tensor on the
        device, else the whole array (module doc)."""
        if isinstance(arr, torch.Tensor) and arr.device == self.device:
            return (arr.contiguous()[None],
                    spatial.all_widths(arr.shape[1], self.sharding))
        return (spatial.shard_w(arr, self.sharding, stride, self.device)[None],
                self.sharding.widths(arr.shape[1], stride))

    def _encode(self, granule_hwc) -> DiagonalGaussian:
        if self.sharding is None:
            return self.model.encode(self._put(granule_hwc))
        x, widths = self._share(granule_hwc, self.stride)
        with spatial.sharded_forward(self.sharding, widths, self.stride):
            return self.model.encode(x)

    def _decode(self, z: torch.Tensor, widths=None) -> torch.Tensor:
        """[1, h, w, Z] (this rank's share with a mesh, of ``widths``)."""
        if self.sharding is None:
            return self.model.decode(z)
        with spatial.sharded_forward(self.sharding, widths):
            return self.model.decode(z)

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        """The whole array of which ``t`` [h, w, ...] is this rank's share
        (``t`` itself without a mesh), as fp32 numpy on the host: every
        rank gets it."""
        if self.sharding is not None:
            t = spatial.gather_w(t[None], self.sharding, host=True)[0]
        return t.float().cpu().numpy()

    def whole_width(self, t: torch.Tensor) -> int:
        """The W of the whole array of which ``t`` [H, w, C] is this rank's
        share (``t``'s own without a mesh)."""
        if self.sharding is None:
            return t.shape[1]
        return sum(spatial.all_widths(t.shape[1], self.sharding))

    @torch.inference_mode()
    def normalize_tensor(self, rad: Union[np.ndarray, torch.Tensor]
                         ) -> torch.Tensor:
        """Training-equivalent normalization + /multiple crop on the
        codec's device: raw [mirror, track, spectral] -> [H, W, C] fp32
        (with a mesh, this rank's W share of it)."""
        if self.sharding is None:
            z = normalize_radiance(self._put(rad)[0], *self._spectra)
            return crop_to_multiple(z, self.multiple).contiguous()
        h = (rad.shape[0] // self.multiple) * self.multiple
        w = (rad.shape[1] // self.multiple) * self.multiple
        lo, hi = self.sharding.bounds(w, self.stride)
        spectra = self._spectra
        if spectra[0] is None or spectra[1] is None:
            spectra = self._own_spectra(rad, lo, hi, w)
        piece = spatial.shard_w(rad[:h, :w], self.sharding, self.stride,
                                self.device)
        return normalize_radiance(piece, *spectra)

    def _own_spectra(self, rad, lo: int, hi: int, w: int) -> list:
        """The whole raw granule's own per-channel mean and std of the log
        radiance (before the crop, as on one device), from each rank's
        columns [lo, hi) (the last rank's also those past the crop ``w``),
        over the ranks: a float64 sum for the mean, then one of the squared
        deviations."""
        last = self.sharding.rank == self.sharding.world - 1
        cols = rad[:, lo:rad.shape[1] if last else hi]
        if not isinstance(cols, torch.Tensor):
            cols = torch.from_numpy(np.array(cols))
        z = torch.clamp(cols.to(self.device).float(), min=1.0).log_()
        z = z.reshape(-1, z.shape[-1])
        count = torch.tensor([float(z.shape[0])], dtype=torch.float64,
                             device=self.device)
        count = spatial.all_reduce_sum(count, self.sharding)
        mean = spatial.all_reduce_sum(z.sum(0, dtype=torch.float64),
                                      self.sharding) / count
        sq = (z.double() - mean).square_().sum(0)
        var = spatial.all_reduce_sum(sq, self.sharding) / count
        return [mean.float(), var.sqrt().float()]

    def normalize(self, rad: np.ndarray) -> np.ndarray:
        """``normalize_tensor`` as a whole host array."""
        return self.to_host(self.normalize_tensor(rad))

    @torch.inference_mode()
    def encode(self, granule_hwc: Union[np.ndarray, torch.Tensor]
               ) -> torch.Tensor:
        """Normalized [H, W, C] -> posterior MEAN latent [H/4, W/4, Z] on
        the device (with a mesh, this rank's share [H/4, w/4, Z]: the
        latent stays split along W)."""
        return self._encode(granule_hwc).mean[0]

    @torch.inference_mode()
    def encode_posterior(self, granule_hwc: np.ndarray) -> DiagonalGaussian:
        """The posterior over the latent (with a mesh, over this rank's
        share)."""
        return self._encode(granule_hwc)

    @torch.inference_mode()
    def decode_tensor(self, latent_hwc: Union[np.ndarray, torch.Tensor]
                      ) -> torch.Tensor:
        """Latent [h, w, Z] -> reconstruction [H, W, C] on the codec's
        device, in the model's compute dtype (with a mesh, this rank's
        share)."""
        if self.sharding is None:
            return self._decode(self._put(latent_hwc))[0]
        z, widths = self._share(latent_hwc, 1)
        return self._decode(z, widths)[0]

    def decode(self, latent_hwc: Union[np.ndarray, torch.Tensor]
               ) -> np.ndarray:
        """Latent [h, w, Z] -> the whole reconstruction [H, W, C] as fp32
        numpy."""
        return self.to_host(self.decode_tensor(latent_hwc))

    @torch.inference_mode()
    def reconstruct(self, granule_hwc: Union[np.ndarray, torch.Tensor],
                    sample_posterior: bool = True) -> np.ndarray:
        """Normalized [H, W, C] -> single-forward reconstruction [H, W, C],
        whole, on the host. With a mesh the posterior noise is drawn for
        the whole latent from the codec's generator and each rank takes its
        columns, so the same seed gives the one-device reconstruction."""
        if self.sharding is None:
            out = self.model.reconstruct(self._put(granule_hwc),
                                         generator=self.generator,
                                         sample_posterior=sample_posterior)
            return out[0].float().cpu().numpy()
        posterior = self._encode(granule_hwc)
        z = posterior.mean
        widths = spatial.all_widths(z.shape[2], self.sharding)
        if sample_posterior:
            lo = sum(widths[:self.sharding.rank])
            noise = torch.randn((*z.shape[:2], sum(widths), z.shape[3]),
                                generator=self.generator, dtype=z.dtype,
                                device=z.device)
            z = z + posterior.std * noise[:, :, lo:lo + z.shape[2]]
        return self.to_host(self._decode(z, widths)[0])

    def reconstruct_raw(self, rad: np.ndarray, sample_posterior: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Raw radiance [mirror, track, spectral] -> (normalized GT crop,
        reconstruction), both whole [H, W, C] host arrays; the normalized
        crop goes to the model without leaving the device."""
        gt = self.normalize_tensor(rad)
        return self.to_host(gt), self.reconstruct(gt, sample_posterior)
