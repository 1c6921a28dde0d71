"""Model math for the split-execution families (dense / MoE decoders
with GQA or MLA attention), as plain functions over param dicts."""
