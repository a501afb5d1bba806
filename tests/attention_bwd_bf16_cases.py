"""The bfloat16 backward's test cases, shared by the card's tests
(``test_torch_cuda.py``) and the CPU emulation of the kernel's arithmetic
(``test_torch_attention.py``, the cases with S <= 300)."""

# (B, H, S, D, causal, kv repeat, seed) of the bfloat16 backward: widths 32,
# 64, 80 (the 128-wide template, padded) and 128, causal and not, k / v
# repeated over the query heads (GQA) as the models hand them over, a row
# count past one 64-row tile that is not a multiple of 16, and 4,096 rows:
# each gradient's sum runs through one wgmma chain over every streamed
# tile, where the tensor cores' alignment of addends could grow with S
ATTN_BWD_BF16_CASES = {
    "d32_causal": (2, 4, 100, 32, True, 1, 0),
    "d64_noncausal_gqa": (2, 6, 300, 64, False, 3, 1),
    "d64_causal_gqa": (2, 14, 257, 64, True, 7, 2),
    "d80_noncausal": (2, 4, 129, 80, False, 1, 3),
    "d80_causal": (1, 2, 200, 80, True, 1, 4),
    "d128_causal_gqa": (2, 4, 200, 128, True, 2, 5),
    "d128_noncausal": (1, 3, 77, 128, False, 1, 6),
    "d128_causal_s4096": (1, 2, 4096, 128, True, 1, 7),
}
