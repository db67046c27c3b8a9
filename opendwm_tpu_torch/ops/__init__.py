"""Hand-written Hopper kernels of the port, each beside its plain version."""

from __future__ import annotations

from opendwm_tpu_torch.ops import (
    flash_attention,
    flash_tail,
    fused_adaln,
    tail_variants,
)


def reset_launch_counts() -> None:
    flash_attention.reset_launches()
    flash_tail.reset_launches()
    fused_adaln.reset_launches()
    tail_variants.reset_launches()


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {
        "flash_attention": flash_attention.launches,
        "flash_attention_by_shape": {
            ",".join(map(str, k)): n
            for k, n in flash_attention.launches_by_shape.items()},
        "flash_attention_with_lse": flash_attention.lse_launches,
        "flash_attention_sm90": flash_attention.sm90_launches,
        "flash_attention_backward": flash_attention.backward_launches,
        "flash_attention_backward_sm90":
            flash_attention.sm90_backward_launches,
        "flash_attention_backward_by_shape": {
            ",".join(map(str, k)): n
            for k, n in flash_attention.backward_launches_by_shape.items()},
        "flash_attention_segment": flash_attention.segment_launches,
        "flash_attention_segment_by_shape": {
            ",".join(map(str, k)): n
            for k, n in flash_attention.segment_launches_by_shape.items()},
        "flash_tail": flash_tail.launches,
        "flash_tail_by_seq": dict(flash_tail.launches_by_seq),
        "flash_tail_with_lse": flash_tail.lse_launches,
        "flash_tail_sm90": flash_tail.sm90_launches,
        "flash_tail_backward": flash_tail.backward_launches,
        "flash_tail_backward_sm90": flash_tail.sm90_backward_launches,
        "flash_tail_backward_by_seq": dict(
            flash_tail.backward_launches_by_seq),
        "adaln_modulate": fused_adaln.launches,
        "residual_adaln_modulate": fused_adaln.res_launches,
        "tail_hpack": sum(tail_variants.hpack_launches_by_nh.values()),
        "tail_hpack_by_nh": dict(tail_variants.hpack_launches_by_nh),
        "tail_qsplit": sum(tail_variants.qsplit_launches_by_bq.values()),
        "tail_qsplit_by_bq": dict(tail_variants.qsplit_launches_by_bq),
    }
