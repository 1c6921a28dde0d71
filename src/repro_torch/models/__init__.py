"""Model math as plain functions over param dicts: the split-execution
families (dense / MoE decoders with GQA or MLA attention) and the fused
dense-cache families (ssm, hybrid) behind the ``model.Model`` facade."""
