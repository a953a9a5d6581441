"""Typed configuration for the PyTorch/CUDA detector.

The fields, names and defaults are those of the reference application's
settings (``root/code/backend/settings.py:1-33``) and of the JAX package's
``Config``, so a JSON config file drives either package.  Every knob is
implemented; the one input the port refuses is an orbax checkpoint
directory (``engine/detector.py``), which raises ``NotImplementedError``
naming the JAX package's ``convert-ckpt`` export to ``.pth``.

Reference constant map (file:line → field):
  settings.py:4-6    n_fft=512, win_length=512, hop_length=256
  settings.py:9      step_size=0.6 (window stride, seconds)
  settings.py:12     prediction_batch_size=32
  settings.py:13     threshold=0.1 (raw-logit score threshold)
  settings.py:16     vad_resample=22050 (internal sample rate)
  settings.py:26     minimum_detection_len=0.1
  pytorch_neural_nets.py:92-99  mel frontend: n_fft*4=2048, n_mels=128, f_max=8000
  worker.py:59-62    pad_seconds=3 (zero padding both sides)
  worker.py:97       break_duration=0.5 (region merge gap)
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class DspConfig:
    """Spectrogram frontend constants (parity-critical)."""

    sample_rate: int = 22050          # settings.py:16
    n_fft: int = 2048                 # pytorch_neural_nets.py:94 (settings.n_fft*4)
    win_length: int = 512             # settings.py:5
    hop_length: int = 256             # settings.py:6
    n_mels: int = 128                 # pytorch_neural_nets.py:87
    f_min: float = 0.0                # torchaudio default
    f_max: float = 8000.0             # pytorch_neural_nets.py:98
    frames_per_window: int = 256      # pytorch_neural_nets.py:150 (259→256 trim)
    display_n_fft: int = 512          # voice_activity.py:148-154


@dataclass(frozen=True)
class EngineConfig:
    """Sliding-window inference constants (NNDetector.py:55-190)."""

    window_seconds: float = 3.0       # NNDetector.py:68
    step_seconds: float = 0.6         # settings.py:9
    pad_seconds: float = 3.0          # worker.py:59
    batch_size: int = 32              # settings.py:12
    threshold: float = 0.1            # settings.py:13
    break_duration: float = 0.5       # worker.py:97
    # hysteresis exit level (engine/regions.py); None = reference behaviour
    exit_threshold: Optional[float] = None
    # music post-filter threshold (engine/postfilter.py); None = off
    music_filter: Optional[float] = None
    # odd running-median width over the averaged grid; 0 = off
    grid_smooth: int = 0
    minimum_detection_len: float = 0.1  # settings.py:26
    min_count: int = 1                # NNDetector.py:153 (min windows per grid bin)

    # "parity" -> float32 everywhere, TF32 off; "fast" -> bfloat16 convs
    # with float32 accumulation and the hand-written mel kernel
    precision: str = "fast"
    # windows per U-Net forward
    device_batch: int = 128
    # seconds of audio per chunk program (rounded to whole batches)
    chunk_seconds: float = 150.0
    # skip files whose detections already exist in the CSV
    skip_processed_files: bool = True
    # fused pipeline: save the chunk journal (engine/journal.py) every N
    # chunks so a killed run resumes mid-file; 0 = no journal
    chunk_checkpoint_every: int = 0
    # files detected concurrently by the runner (worker threads); results
    # persist in submission order
    file_concurrency: int = 1
    # chunks prepared (host fill + pinned upload) ahead of the device
    readahead_chunks: int = 4
    # fused pipeline's PCM upload wire: "pcm16" (exact int16), "mulaw8"
    # (8-bit mu-law, ops/mulaw.py) or "adpcm4" (4-bit IMA-ADPCM,
    # ops/adpcm.py, decoded on the card by the CUDA kernel K3).  "auto"
    # picks mulaw8 only on a TPU (the JAX package's policy), so here it is
    # pcm16; any other value rides the exact wire too, as in the JAX package
    upload_codec: str = "auto"
    # host decimation of the wire stream (io/decimate.py) by the largest
    # integer M with native_sr/M >= 2*dsp.f_max (32 kHz -> 16 kHz): "auto"
    # engages it on the lossy wires only, "off" never
    wire_decimate: str = "auto"
    # the host pipeline's streaming resampler: "host" (scipy polyphase) or
    # "device" (a polyphase GEMM per chunk on the detector's device);
    # "auto" = device on CUDA, host elsewhere
    resample_backend: str = "host"
    # mel frontend: "fused" = the CUDA framing+DFT+mel kernel K1
    # (ops/frame_mel.py), "pallas" = the float32 DFT→mel CUDA kernel K2 over
    # gathered frames (ops/dft_mel.py; mel_precision does not apply), "xla" =
    # the plain two-matmul torch chain (ops/mel.py).  The names are the JAX
    # package's, kept for config-file compatibility.  "auto" = fused on CUDA
    # in fast mode, the plain chain in parity mode and on the CPU.
    mel_kernel: str = "auto"
    # DFT product precision: "highest" (fp32), "high" (bf16x3),
    # "default" (one bf16 pass).  "auto" = "highest" in parity mode, else
    # "default".  The mel product stays fp32 in every mode.
    mel_precision: str = "auto"
    # decoder strategy: "auto", "concat" or "phase"; the port computes
    # concat for each ("phase" is the same function another way)
    decoder_upsample: str = "auto"
    # 3×3 conv implementation: "auto", "direct" or "packed"; the port
    # computes direct for each ("packed" is the same function another way)
    conv_impl: str = "auto"
    # detection pipeline: "fused" (engine/fused.py) or "host"
    # (engine/detector.py); "auto" = fused on CUDA, host elsewhere
    pipeline: str = "auto"
    # unused here: the per-batch forward is a Python loop
    scan_unroll: int = 1


# the checkout holding this package: the trained checkpoint ships under it
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class PathsConfig:
    # the trained weights (48,750 steps), exported from the orbax checkpoint
    # beside them; found from any working directory
    model_dir: str = os.path.join(_CHECKOUT, "root", "models", "spec_unet_2d")
    model_name: str = "model_checkpoint.pth"
    project_dir: str = os.path.join(".", "projects")
    user_guide_url: str = "https://github.com/AVianEco/Softspoken"


@dataclass(frozen=True)
class Config:
    dsp: DspConfig = field(default_factory=DspConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    cpu_threads: int = field(default_factory=lambda: max(1, (os.cpu_count() or 2) // 2))

    @property
    def samples_per_window(self) -> int:
        # 3 s * 22050 Hz = 66150 (NNDetector.py:74)
        return int(self.dsp.sample_rate * self.engine.window_seconds)

    @property
    def samples_per_step(self) -> int:
        # floor(22050 * 0.6) = 13230 (NNDetector.py:75)
        return math.floor(self.dsp.sample_rate * self.engine.step_seconds)

    @property
    def pad_samples(self) -> int:
        return int(self.dsp.sample_rate * self.engine.pad_seconds)

    @property
    def time_resolution(self) -> float:
        # 3 s / 256 bins = 11.71875 ms (NNDetector.py:172)
        return self.engine.window_seconds / self.dsp.frames_per_window

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    def with_engine(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, engine=dataclasses.replace(self.engine, **kw))

    def with_dsp(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, dsp=dataclasses.replace(self.dsp, **kw))

    def with_paths(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, paths=dataclasses.replace(self.paths, **kw))

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        cfg = Config()
        if "dsp" in d:
            cfg = cfg.with_dsp(**d["dsp"])
        if "engine" in d:
            cfg = cfg.with_engine(**d["engine"])
        if "paths" in d:
            cfg = cfg.with_paths(**d["paths"])
        if "cpu_threads" in d:
            cfg = dataclasses.replace(cfg, cpu_threads=d["cpu_threads"])
        return cfg

    @staticmethod
    def from_file(path: str) -> "Config":
        with open(path, "r") as f:
            return Config.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def parity_config() -> Config:
    """The reference's defaults plus strict numerics."""
    return Config().with_engine(precision="parity", skip_processed_files=False)


DEFAULT_CONFIG = Config()
