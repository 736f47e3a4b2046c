"""Device ms a training step in the segment sampler, the program's stage
span `nr.sampleSegments` (`train/dataset.py::sample_segment_batch`: the
shell sweeps and ground-truth traces of the batch's rays), from its CUDA
event pairs: from the device reaching the stage's first event to
reaching its last, so idle inside the stage counts."""

from layers._program import stage_ms


def read(tr):
    return stage_ms(tr, "sampleSegments")
