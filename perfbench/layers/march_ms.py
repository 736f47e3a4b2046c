"""Device ms a call in the shell march, the program's stage span
`nr.shellTrace` (each `trace_neural_segments` of the frame, camera and
bounces, the network's `nr.neuralForward` inside), from its CUDA event
pairs: from the device reaching the stage's first event to reaching its
last, so idle inside the stage, the march's host syncs among it, counts."""

from layers._program import stage_ms


def read(tr):
    return stage_ms(tr, "shellTrace")
