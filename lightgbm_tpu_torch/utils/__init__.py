"""Small shared helpers."""


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()
