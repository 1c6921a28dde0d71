"""CrossPool core, ported: the paged KV virtualizer, the expert-slab
weights arena, admission, the pool objects, split execution and the
fused decode control.

* virtualizer  — paged KV virtualization of one shared physical pool
* weight_pool  — expert-slab weights arena: cold-model activation/eviction
* admission    — queue-or-reject enforcement of the budgets
* pools        — KVCachePool / WeightsPool engine-level disaggregation
* split_exec   — proxy-layer split of attention vs FFN execution
* control      — streaming prefill and the K-token fused decode step
"""
