"""Training of the shell network: port of `neural_renderer_tpu/train`."""

from .dataset import (SegmentBatch, sample_rays, sample_segment_batch,
                      segment_batch_from_rays)
from .losses import LossWeights, bce_with_logits, shell_losses
from .trainer import (
    TrainConfig,
    TrainState,
    export_reference_blob,
    init_train_state,
    make_optimizer,
    make_train_step,
    make_train_step_on_batch,
    restore_checkpoint,
    save_checkpoint,
    scene_global_row,
    segment_domain,
)
