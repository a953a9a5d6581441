"""Augmentation parameter ranges (from the JAX package's ``train/augment.py``).

Only ``PARAM_RANGES`` is here: the on-device synthesizer reads the
``gain_ramp`` range from it (``train/device_data.py``).  The host
augmentations come with the host trainer.
"""

from __future__ import annotations

from typing import Dict, Tuple

# reference ranges: voice_activity.py:314-343
PARAM_RANGES: Dict[str, Dict[str, Tuple[float, float]]] = {
    "change_pitch": {"pitch_factor": (-3.0, 3.0)},
    "change_speed": {"speed_factor": (0.80, 1.2)},
    "add_reverb": {
        "reverb_level": (0.2, 0.8),
        "decay_time": (0.2, 1.0),
        "num_delays": (1.0, 5.0),
    },
    "reduce_volume": {"reduction_level": (0.1, 0.99)},
    "add_echo": {"echo_delay": (0.1, 0.7), "decay_factor": (0.3, 0.7)},
    "bandpass_filter": {"low_freq": (100.0, 500.0), "high_freq": (600.0, 2500.0)},
    "add_harmonic_distortion": {"distortion_level": (10.0, 50.0)},
    "compress_dynamics": {
        "compression_ratio": (1.5, 6.0),
        "threshold_level": (-40.0, -10.0),
    },
    # not a reference augmentation: a within-clip channel-gain ramp, the
    # analog of the slow-fading channel of the evaluation grid; opt-in only
    "gain_ramp": {"start_db": (-18.0, 0.0), "end_db": (-18.0, 0.0)},
}
