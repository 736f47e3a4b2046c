"""Multi-GPU parallelism: port of `neural_renderer_tpu/parallel`."""

from .shardings import (
    bilateral_denoise_tiled,
    constrain_batch_dp,
    dp_shard_batch,
    make_mesh,
    psnr_tiled,
    render_gt_frame_tiled,
    render_neural_frame_tiled,
    shard_params_spec,
    shard_train_state,
)
