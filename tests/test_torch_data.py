"""The port's synthetic LM stream against the reference's, on the CPU.

``repro_torch.data.pipeline`` is a copy of the reference's numpy
pipeline: ``batch_at`` must give the reference's tokens and labels bit
for bit, with ``markov_order`` on and off, over vocabularies, lengths
(odd and even), batches, seeds and steps; ``stream(start_step)`` yields
the same batches in order; the batches go onto the pipeline's device,
the card unless the caller asks for the CPU.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro_torch.data.pipeline import DataConfig, SyntheticLM

CASES = [(101, 16, 4, 3), (512, 33, 2, 0), (151936, 64, 1, 0),
         (32768, 128, 4, 7), (2, 5, 3, 2 ** 40)]


@pytest.mark.parametrize("markov", [True, False], ids=["markov", "noise"])
@pytest.mark.parametrize("vocab,seq,batch,seed", CASES)
def test_batch_at_is_the_references(vocab, seq, batch, seed, markov):
    port = SyntheticLM(DataConfig(vocab, seq, batch, seed,
                                  markov_order=markov), device="cpu")
    ref = JaxSyntheticLM(JaxDataConfig(vocab, seq, batch, seed,
                                       markov_order=markov))
    for step in (0, 1, 7, 12345, 2 ** 31 - 1):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == torch.int32
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k} at step {step}")
            np.testing.assert_array_equal(port.batch_np(step)[k], want[k])


def test_stream_yields_the_batches_in_order():
    cfg = dict(vocab=101, seq=16, global_batch=4, seed=3)
    port = SyntheticLM(DataConfig(**cfg, prefetch=3), device="cpu")
    ref = JaxSyntheticLM(JaxDataConfig(**cfg))
    for start in (0, 5):
        for i, b in enumerate(itertools.islice(port.stream(start), 6)):
            np.testing.assert_array_equal(
                b["tokens"].numpy(), ref.batch_at(start + i)["tokens"])


def test_deterministic_and_learnable():
    """The reference's own case (``tests/test_substrate.py``)."""
    ds = SyntheticLM(DataConfig(vocab=101, seq=16, global_batch=4, seed=3),
                     device="cpu")
    b1, b2 = ds.batch_at(7), ds.batch_at(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 16)
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
    assert int(b1["tokens"].max()) < 101
    assert not torch.equal(b1["tokens"], ds.batch_at(8)["tokens"])
    # odd positions follow their predecessor: (prev * 31 + 7) % vocab
    t = ds.batch_np(3)["tokens"]
    assert ((t[:, :-1:2].astype(np.int64) * 31 + 7) % 101 ==
            t[:, 1::2]).all()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(DataConfig(vocab=64, seq=8, global_batch=2))
