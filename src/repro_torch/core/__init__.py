"""CrossPool core, ported: the paged KV virtualizer, the expert-slab
weights arena, admission, the pool objects, split execution, the fused
decode control, and the elastic boundary between the two pools.

* planner      — Eq. (1)-(2) Monte Carlo pool sizing and the page_budget
                 vs slot_budget device-bytes split
* virtualizer  — paged KV virtualization of one shared physical pool,
                 with the host swap tier and live resize
* weight_pool  — expert-slab weights arena: cold-model activation/eviction
                 and live resize
* admission    — queue-or-reject enforcement of the budgets
* elastic      — online KV<->weights boundary rebalancer
* pools        — KVCachePool / WeightsPool engine-level disaggregation
* split_exec   — proxy-layer split of attention vs FFN execution
* control      — streaming prefill and the K-token fused decode step
"""
