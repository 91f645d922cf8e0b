from emg_tpu_torch.utils.audio import splice_audio  # noqa: F401
from emg_tpu_torch.utils.confusion import confusion_matrix, print_confusion  # noqa: F401
from emg_tpu_torch.utils.profiling import profile_trace, span  # noqa: F401
