"""Options the port does not act on yet refuse, and ``--debug`` runs on the
CPU, as the JAX package's CLI does (``emg_tpu/cli.py``: ``--debug`` forces
the CPU platform).

- ``model.remat`` (the JAX package rematerializes encoder layers) raises
  ``NotImplementedError`` when the model is built, rather than being
  accepted and ignored.
- ``--debug`` hands ``device="cpu"`` to both CLI modes, whatever
  ``--device`` says.
"""

from __future__ import annotations

import pytest

from emg_tpu_torch import cli
from emg_tpu_torch.config import ModelConfig
from emg_tpu_torch.models.model import EMGModel

SMALL = dict(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
             num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2, relative_distance=8)


@pytest.mark.parametrize("option, pattern", [
    (dict(remat=True), "remat"),
], ids=["remat"])
def test_unported_model_options_raise(option, pattern):
    with pytest.raises(NotImplementedError, match=pattern):
        EMGModel(ModelConfig(**SMALL, **option), device="cpu")


@pytest.mark.parametrize("mode, extra", [
    ("train", []),
    ("evaluate_saved_greedy_search", ["--evaluate_saved_greedy_search", "model.pt"]),
])
@pytest.mark.parametrize("flags, expected", [
    (["--debug"], "cpu"),
    (["--debug", "--device", "cuda"], "cpu"),
    (["--device", "cpu"], "cpu"),
    ([], "cuda"),
], ids=["debug", "debug_over_device", "device_cpu", "default"])
def test_debug_runs_on_the_cpu(tmp_path, monkeypatch, mode, extra, flags, expected):
    seen = []
    monkeypatch.setattr(cli, mode, lambda cfg, device="cuda": seen.append((cfg, device)))
    cli.main(["--output_directory", str(tmp_path)] + extra + flags)
    assert [device for _, device in seen] == [expected]
    assert seen[0][0].paths.debug == ("--debug" in flags)
