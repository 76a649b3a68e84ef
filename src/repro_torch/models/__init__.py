"""Decoder assembly of all four families (dense, moe, rwkv6,
hybrid_mamba2) over the paged KV pool, the per-slot ring or the
recurrent state."""
