"""Dense full-attention decoder LM (ATTN_FULL blocks, dense FFN)."""
