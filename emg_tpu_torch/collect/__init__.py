from emg_tpu_torch.collect.board import SyntheticBoard, AudioInput, make_board  # noqa: F401
from emg_tpu_torch.collect.recorder import Recorder, filter_signal, get_last_sequence  # noqa: F401
from emg_tpu_torch.collect.book import Book  # noqa: F401
from emg_tpu_torch.collect.session import RecordingSession, save_data, get_ends  # noqa: F401
from emg_tpu_torch.collect.denoise import clean_directory, reduce_noise  # noqa: F401
