from sdr_tpu.obs.sweep import SweepPoint, SweepResult, ebno_sweep  # noqa: F401
from sdr_tpu.obs.roofline import RooflineReport, chip_peaks, demod_roofline  # noqa: F401
from sdr_tpu.obs.profile import trace  # noqa: F401
from sdr_tpu.obs.autotune import TunePoint, recommend_crossover, tune_fft  # noqa: F401
from sdr_tpu.obs.metrics import Metrics, global_metrics  # noqa: F401
