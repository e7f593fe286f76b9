# Copied from flowmirror_hydravox_tpu/utils/i18n.py; the port keeps its own copy.
"""Bilingual (zh/en) user-facing messages (reference server/i18n.py:1-114).

`t(key, **kwargs)` returns the message in the language selected by
HYDRAVOX_LANG (default en here; the reference defaults zh)."""

from __future__ import annotations

import os

_TABLE = {
    "synth_done": {
        "en": "synthesis done: {duration:.2f}s, tps {tps:.1f}, rtf {rtf:.3f}",
        "zh": "推理完成：{duration:.2f}秒，TPS {tps:.1f}，RTF {rtf:.3f}",
    },
    "synth_failed": {"en": "synthesis failed: {error}", "zh": "语音合成失败：{error}"},
    "tts_timeout": {"en": "tts timeout", "zh": "TTS 请求超时"},
    "unknown_speaker": {
        "en": "unknown speaker '{spk}'; available: {speakers}",
        "zh": "未知说话人 '{spk}'；可选：{speakers}",
    },
    "missing_prompt_audio": {
        "en": "prompt_audio_base64 required",
        "zh": "缺少提示音频 prompt_audio_base64",
    },
    "weights_loaded": {"en": "loaded weights: {path}", "zh": "已加载模型权重：{path}"},
    "training_started": {"en": "training started: {tid}", "zh": "训练已启动：{tid}"},
    "training_running": {
        "en": "a training is already running",
        "zh": "已有训练正在运行",
    },
    "training_stopped": {"en": "training stopped", "zh": "训练已停止"},
    "training_unknown": {"en": "unknown training {tid}", "zh": "未知训练任务 {tid}"},
    "training_failed": {"en": "training failed: {error}", "zh": "训练失败：{error}"},
    "training_done": {"en": "training finished", "zh": "训练已完成"},
    "data_stage_started": {"en": "data stage {stage} started: {tid}",
                           "zh": "数据处理阶段 {stage} 已启动：{tid}"},
    "data_stage_failed": {"en": "data stage failed: {error}",
                          "zh": "数据处理失败：{error}"},
    "data_stage_unknown": {"en": "unknown data stage {stage}", "zh": "未知数据阶段 {stage}"},
    "model_deleted": {"en": "deleted {path}", "zh": "已删除 {path}"},
    "model_not_found": {"en": "model not found: {path}", "zh": "模型不存在：{path}"},
    "model_path_escape": {"en": "path escapes models root: {path}",
                          "zh": "路径越界（超出模型根目录）：{path}"},
    "convert_started": {"en": "conversion started: {tid}", "zh": "权重转换已启动：{tid}"},
    "convert_failed": {"en": "conversion failed: {error}", "zh": "权重转换失败：{error}"},
    "speaker_added": {"en": "speaker '{spk}' added", "zh": "说话人 '{spk}' 已添加"},
    "speaker_removed": {"en": "speaker '{spk}' removed", "zh": "说话人 '{spk}' 已删除"},
    "speaker_exists": {"en": "speaker '{spk}' already exists", "zh": "说话人 '{spk}' 已存在"},
    "audio_decode_failed": {"en": "could not decode audio: {error}",
                            "zh": "音频解码失败：{error}"},
    "bad_request": {"en": "bad request: {error}", "zh": "请求格式错误：{error}"},
    "missing_field": {"en": "missing field: {field}", "zh": "缺少字段：{field}"},
    "server_ready": {"en": "server listening on {host}:{port}",
                     "zh": "服务已启动，监听 {host}:{port}"},
    "prewarm_start": {"en": "prewarming compiled programs...",
                      "zh": "正在预编译热点程序..."},
    "prewarm_done": {"en": "prewarm done in {secs:.1f}s", "zh": "预编译完成，耗时 {secs:.1f} 秒"},
    "vc_failed": {"en": "voice conversion failed: {error}", "zh": "声音转换失败：{error}"},
    "text_empty": {"en": "text is empty", "zh": "合成文本为空"},
    "text_too_long": {"en": "text too long ({n} chars), segmenting",
                      "zh": "文本过长（{n} 字符），将分段合成"},
    "prompt_too_long": {"en": "prompt audio capped at {secs}s",
                        "zh": "提示音频超长，截断至 {secs} 秒"},
}


def language() -> str:
    lang = os.environ.get("HYDRAVOX_LANG", os.environ.get("HYDRAVOX_UI_LANG", "en")).lower()
    return lang if lang in ("zh", "en") else "en"


def t(key: str, **kwargs) -> str:
    entry = _TABLE.get(key)
    if not entry:
        return key
    msg = entry.get(language(), entry["en"])
    try:
        return msg.format(**kwargs)
    except Exception:
        return msg
