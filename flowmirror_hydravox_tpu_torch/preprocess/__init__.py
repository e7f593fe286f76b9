"""The data-preprocessing pipeline (port of flowmirror_hydravox_tpu/preprocess/):
stage 1 `resample`, 2 `vad` (with the native VAD of `vad_model`), 3
`transcribe` (with the native CTC ASR of `asr_model`), 4 `extract_tokens`
and 5 `merge`. Stages 3-5 write saved datasets through `utils/hf_dataset.py`.
"""
