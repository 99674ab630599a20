"""The reference's GPUTransformNeuralfp surface
(modules/transformations.py:9-116) over the port's DSP pieces (port of
``grafp_tpu.dsp.pipeline``), for code written against the reference.

Three modes, one contract:
  * cpu=True   : time-domain corruption of x_j only (IR + noise at
                 tr_snr), on the device from the corpus banks;
  * train=True : log-mel of both 1-s views -> (B, n_mels, n_frames);
  * train=False: log-mel of the full track unfolded into overlapping
                 segments; x_j (if given) corrupted at val_snr first,
                 without IR when abl=True (the "sanir" ablation,
                 test_fp.py:223-231); x_j=None returns the clean segments
                 twice (the dummy DB, transformations.py:93-95).

The draws come from a ``torch.Generator`` seeded with ``seed`` in place
of the JAX package's key.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.dsp.augment import AugmentBanks, augment_waveforms
from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
from grafp_tpu_torch.dsp.segment import unfold_segments


class AudioTransform:
    def __init__(self, cfg, banks: Optional[AugmentBanks] = None,
                 train: bool = True, cpu: bool = False, abl: bool = False,
                 seed: int = 0, device: Optional[Union[str, torch.device]] = None):
        """``device`` None means the CUDA card (raises without one)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        if banks is not None and banks.noise is None and banks.ir is None:
            banks = None
        self.banks = banks.to(self.device) if banks is not None else None
        self.train = train
        self.cpu = cpu
        self.abl = abl
        self.mcfg = LogMelConfig.from_config(cfg)
        self.n_frames = int(cfg["n_frames"])
        self.step = cfg.seg_hop_frames
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _corrupt(self, x: torch.Tensor, snr, ir_prob: float) -> torch.Tensor:
        if self.banks is None:
            return x
        xb = x[None, :] if x.dim() == 1 else x
        out = augment_waveforms(xb, self.banks, self.generator,
                                (float(snr[0]), float(snr[1])), ir_prob=ir_prob,
                                noise_prob=1.0)
        return out[0] if x.dim() == 1 else out

    def __call__(self, x_i, x_j) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if self.cpu:
            x_j = self._corrupt(self._tensor(x_j), cfg["tr_snr"], float(cfg["ir_prob"]))
            return x_i, x_j[..., : int(cfg["fs"] * cfg["dur"])]
        if self.train:
            return (log_mel_spectrogram(self._tensor(x_i), self.mcfg),
                    log_mel_spectrogram(self._tensor(x_j), self.mcfg))
        # eval: full track -> overlapping segments
        spec_i = log_mel_spectrogram(self._tensor(x_i).reshape(-1), self.mcfg)
        X_i = unfold_segments(spec_i, self.n_frames, self.step)
        if x_j is None:
            return X_i, X_i
        ir_prob = 0.0 if self.abl else 1.0
        x_j = self._corrupt(self._tensor(x_j).reshape(-1), cfg["val_snr"], ir_prob)
        X_j = unfold_segments(log_mel_spectrogram(x_j, self.mcfg), self.n_frames, self.step)
        return X_i, X_j
