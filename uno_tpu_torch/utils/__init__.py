from uno_tpu_torch.utils.logger import Logger
from uno_tpu_torch.utils.statistics import Statistics
from uno_tpu_torch.utils.callbacks import UserCallbacks, NoUserCallbacks, RecordingCallbacks

__all__ = ["Logger", "Statistics", "UserCallbacks", "NoUserCallbacks",
           "RecordingCallbacks"]
