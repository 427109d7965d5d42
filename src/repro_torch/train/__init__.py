"""The LM side's steps: training (AdamW, microbatches, remat), prefill
and serving, and the warehouse-fed train loop."""
