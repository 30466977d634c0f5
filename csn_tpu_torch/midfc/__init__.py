"""MID-FC branch: SSA/CSA heads over precomputed O-CNN HRNet features."""


def chunk_size_arg(value: str) -> int:
    """argparse type for --chunk_size: only 0 is the documented full-
    attention sentinel; negative values are typos that would otherwise
    silently switch the attention pattern."""
    import argparse

    v = int(value)
    if v < 0:
        raise argparse.ArgumentTypeError(
            f"--chunk_size must be >= 0 (0 = full attention), got {v}")
    return v
