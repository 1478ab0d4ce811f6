"""The metric stack (``transeditor_tpu/metrics/``): InceptionV3 and FID,
streamed PRDC, PPL, LPIPS diversity, the checkpoint evaluator and the
paired folder metrics."""
