"""Hand-written Hopper kernels of the port, each beside its plain version,
and the int8 product of int8 serving (``quant``: ``torch._int_mm``)."""

from __future__ import annotations

from opendwm_tpu_torch.ops import (
    flash_attention,
    flash_tail,
    fused_adaln,
    quant,
    tail_variants,
)


def reset_launch_counts() -> None:
    flash_attention.reset_launches()
    flash_tail.reset_launches()
    fused_adaln.reset_launches()
    quant.reset_launches()
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
        "flash_attention_segment_with_lse":
            flash_attention.segment_lse_launches,
        "flash_attention_segment_by_shape": {
            ",".join(map(str, k)): n
            for k, n in flash_attention.segment_launches_by_shape.items()},
        "flash_attention_segment_backward":
            flash_attention.segment_backward_launches,
        "flash_attention_segment_backward_sm90":
            flash_attention.segment_sm90_backward_launches,
        "flash_attention_segment_backward_by_shape": {
            ",".join(map(str, k)): n
            for k, n in
            flash_attention.segment_backward_launches_by_shape.items()},
        "flash_tail": flash_tail.launches,
        "flash_tail_by_seq": dict(flash_tail.launches_by_seq),
        "flash_tail_by_shape": {
            ",".join(map(str, k)): n
            for k, n in flash_tail.launches_by_shape.items()},
        "flash_tail_sm90_by_shape": {
            ",".join(map(str, k)): n
            for k, n in flash_tail.sm90_launches_by_shape.items()},
        "flash_tail_with_lse": flash_tail.lse_launches,
        "flash_tail_sm90": flash_tail.sm90_launches,
        "flash_tail_backward": flash_tail.backward_launches,
        "flash_tail_backward_sm90": flash_tail.sm90_backward_launches,
        "flash_tail_backward_by_seq": dict(
            flash_tail.backward_launches_by_seq),
        "flash_tail_backward_by_shape": {
            ",".join(map(str, k)): n
            for k, n in flash_tail.backward_launches_by_shape.items()},
        "adaln_modulate": fused_adaln.launches,
        "adaln_modulate_fixed": fused_adaln.fixed_launches,
        "adaln_modulate_by_shape": {
            ",".join(map(str, k)): n
            for k, n in fused_adaln.launches_by_shape.items()},
        "residual_adaln_modulate": fused_adaln.res_launches,
        "residual_adaln_modulate_fixed": fused_adaln.res_fixed_launches,
        "residual_adaln_modulate_by_shape": {
            ",".join(map(str, k)): n
            for k, n in fused_adaln.res_launches_by_shape.items()},
        "tail_hpack": sum(tail_variants.hpack_launches_by_nh.values()),
        "tail_hpack_by_nh": dict(tail_variants.hpack_launches_by_nh),
        "tail_qsplit": sum(tail_variants.qsplit_launches_by_bq.values()),
        "tail_qsplit_by_bq": dict(tail_variants.qsplit_launches_by_bq),
        "tail_hpack_sm90": tail_variants.hpack_sm90_launches,
        "tail_qsplit_sm90": tail_variants.qsplit_sm90_launches,
        "int8_mm": quant.launches,
        "int8_mm_by_shape": {
            ",".join(map(str, k)): n
            for k, n in quant.launches_by_shape.items()},
    }
