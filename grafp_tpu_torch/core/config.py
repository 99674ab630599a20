"""Typed configuration, the port's own copy of ``grafp_tpu.core.config``.

Same flat-YAML schema and defaults as the JAX package's ``Config`` (the
reference's config/grafp.yaml keys plus the accelerator knobs), so one
YAML file drives both packages. Unknown YAML keys land in ``extras``, and
dict-style ``cfg['key']`` access works as in the reference's scripts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


def _as_list(x, n=None, cast=float):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        out = [cast(v) for v in x]
    else:
        out = [cast(x)]
    if n is not None and len(out) == 1:
        out = out * n
    return out


@dataclass
class Config:
    """Flat experiment configuration (field names are the reference YAML
    keys, one to one)."""

    # --- dataset directories ---
    data_dir: str = "data"
    train_dir: str = "PATH/TO/TRAINING/DATA"
    val_dir: str = "PATH/TO/VALIDATION/DATA"
    ir_dir: Optional[str] = None
    noise_dir: Optional[str] = None

    # --- model input parameters ---
    arch: str = "grafp"          # 'grafp' | 'ast' | 'nafp'
    fs: int = 16000
    dur: float = 1.0
    offset: float = 0.05
    norm: Optional[float] = 0.95
    win_len: int = 1024
    hop_len: int = 512
    n_mels: int = 64
    n_fft: int = 1024
    n_peaks: int = 512
    silence: float = 0.0005
    blur_kernel: List[int] = field(default_factory=lambda: [7, 7])

    # --- dataset and model hyperparameters ---
    train_sz: int = 8000
    val_sz: int = 106574
    bsz_train: int = 256
    peak_stride: int = 2
    n_filters: int = 8
    tau: float = 0.05
    lr: float = 8.0e-5
    min_lr: float = 7.0e-7
    n_epochs: int = 400
    T_max: int = 400
    error_threshold: int = 5
    # 'lambda' is a reserved word: stored as lambda_, serialized as 'lambda'
    lambda_: float = 0.0

    # --- augmentation hyperparameters ---
    n_frames: int = 32
    overlap: float = 0.9
    tr_snr: List[float] = field(default_factory=lambda: [0.0, 20.0])
    val_snr: List[float] = field(default_factory=lambda: [0.0, 10.0])
    test_snr: List[float] = field(default_factory=lambda: [19.0, 21.0])
    time_mask: int = 8
    freq_mask: int = 16
    noise_prob: float = 1.0
    ir_prob: float = 1.0

    # --- model architecture ---
    d: int = 128      # fingerprint dimension
    h: int = 1024     # encoder embedding dimension
    u: int = 32       # projector expansion (hidden = d*u)

    # --- validation database sizes ---
    n_dummy: int = 100
    n_query: int = 20

    # --- extensions of the reference schema ---
    # Graph encoder topology; the defaults reproduce the reference's
    # effective behaviour (size 't', k=3, dilation 1 and drop_path 0 in
    # every block, because the reference never increments its block index).
    size: str = "t"
    k: int = 3
    dilation_schedule: str = "reference"  # 'reference' (all 1) | 'ramp'
    drop_path: float = 0.1                # peak rate when schedule='ramp'
    drop_path_schedule: str = "reference"  # 'reference' (all 0) | 'ramp'

    # numerics / performance
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16' matmul inputs
    serve_quant: str = "none"        # 'none' | 'int8' | 'int8_static' | ...
    bn_cross_replica: bool = False
    knn_block_size: int = 0
    knn_strategy: str = "auto"
    use_pallas: bool = True
    remat: bool = False

    # mesh / parallelism
    mesh_data: int = 0
    mesh_db: int = 0

    # retrieval defaults (reference eval.py)
    index_type: str = "ivfpq"
    n_centroids: int = 64
    nprobe: int = 20
    k_probe: int = 20
    scan_topk: str = "exact"
    scan_recall: float = 0.99

    # anything in the YAML we do not model explicitly
    extras: Dict[str, Any] = field(default_factory=dict)

    _ALIASES = {"lambda": "lambda_"}

    def __getitem__(self, key: str) -> Any:
        key = self._ALIASES.get(key, key)
        if hasattr(self, key):
            return getattr(self, key)
        return self.extras[key]

    def __setitem__(self, key: str, value: Any) -> None:
        key = self._ALIASES.get(key, key)
        if hasattr(self, key):
            object.__setattr__(self, key, value)
        else:
            self.extras[key] = value

    def __contains__(self, key: str) -> bool:
        key = self._ALIASES.get(key, key)
        return hasattr(self, key) or key in self.extras

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    @property
    def clip_frames(self) -> int:
        """Samples per 1-second training clip (reference data.py:59)."""
        return int(self.fs * self.dur)

    @property
    def n_nodes(self) -> int:
        """Graph nodes emitted by the peak embedder
        (n_mels * n_frames // peak_stride)."""
        return self.n_mels * self.n_frames // self.peak_stride

    @property
    def seg_hop_frames(self) -> int:
        """Frame hop between overlapping eval segments,
        int(n_frames * (1 - overlap)), floored at 1 so degenerate
        geometries keep a well-defined unfold."""
        return max(1, int(self.n_frames * (1 - self.overlap)))

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            if f.name == "extras":
                continue
            name = "lambda" if f.name == "lambda_" else f.name
            out[name] = getattr(self, f.name)
        out.update(self.extras)
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            yaml.safe_dump(self.to_dict(), fp, sort_keys=False)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)} - {"extras"}


def load_config(config_path: str) -> Config:
    """Load a reference-schema YAML into a typed Config; unknown keys land
    in ``extras``."""
    with open(config_path, "r") as fp:
        raw = yaml.safe_load(fp) or {}
    return config_from_dict(raw)


def config_from_dict(raw: Dict[str, Any]) -> Config:
    kwargs: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}
    for key, val in raw.items():
        name = Config._ALIASES.get(key, key)
        if name in _FIELD_NAMES:
            kwargs[name] = val
        else:
            extras[name] = val
    cfg = Config(**kwargs, extras=extras)
    # normalize SNR ranges to 2-element float lists
    cfg.tr_snr = _as_list(cfg.tr_snr, 2)
    cfg.val_snr = _as_list(cfg.val_snr, 2)
    cfg.test_snr = _as_list(cfg.test_snr, 2)
    return cfg


def override(config_val: Any, arg: Any) -> Any:
    """CLI-over-YAML precedence, as the reference's util.py:129-130."""
    return arg if arg is not None else config_val
