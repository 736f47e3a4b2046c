"""Device ms a call in the bounce sampler, the program's stage span
`nr.sampleBounce` (`pathtrace.sample_bounce_directions` and
`update_active_after_sampling`), from its CUDA event pairs: from the
device reaching the stage's first event to reaching its last, so idle
inside the stage counts."""

from layers._program import stage_ms


def read(tr):
    return stage_ms(tr, "sampleBounce")
