# Copied from flowmirror_hydravox_tpu/runtime/webui.py; the port keeps its own copy.
"""Built-in web UI (reference user_interface/ Gradio tabs equivalent).

A single dependency-free HTML page served by the API server itself (the
launcher's `--with-ui`, `serve(..., with_ui=True)`): GET / answers with it.
It covers the reference's tabs: inference (preset-speaker TTS + params),
zero-shot voice cloning (wav upload), data preprocessing (stages 1-5 with
live logs), training (start/stop/status + live log tail + loss-curve plot),
model management (list/delete/convert) and speakers. The zh/en language
toggle mirrors the reference's UI i18n; all strings live in the I18N table
below. All actions go through the same REST API as the reference UI's
APIClient. The page is the JAX package's, but for its title and demo text.
"""

INDEX_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8"/>
<title>HydraVox GPU</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 0; background: #f5f6f8; color: #1d2733; }
 header { background: #16324f; color: #fff; padding: 14px 24px; font-size: 20px; display: flex; justify-content: space-between; align-items: center; }
 header .lang button { background: #1d4065; color: #cfe0f1; border: 1px solid #3a5a7d; padding: 4px 10px; cursor: pointer; border-radius: 4px; font-size: 13px; }
 header .lang button.active { background: #f5f6f8; color: #16324f; }
 nav { display: flex; gap: 4px; background: #1d4065; padding: 0 16px; flex-wrap: wrap; }
 nav button { background: none; border: none; color: #cfe0f1; padding: 10px 16px; cursor: pointer; font-size: 14px; }
 nav button.active { background: #f5f6f8; color: #16324f; border-radius: 6px 6px 0 0; }
 main { padding: 24px; max-width: 900px; margin: 0 auto; }
 section { display: none; background: #fff; border-radius: 8px; padding: 20px; box-shadow: 0 1px 3px rgba(0,0,0,.08); }
 section.active { display: block; }
 label { display: block; margin: 10px 0 4px; font-size: 13px; color: #49617a; }
 textarea, input, select { width: 100%; box-sizing: border-box; padding: 8px; border: 1px solid #c6d2de; border-radius: 6px; font-size: 14px; }
 textarea { min-height: 90px; }
 .row { display: flex; gap: 12px; } .row > div { flex: 1; }
 button.go { margin-top: 14px; background: #2374ab; color: #fff; border: none; padding: 10px 22px; border-radius: 6px; font-size: 15px; cursor: pointer; }
 button.go:disabled { background: #9db4c8; }
 button.danger { background: #ab3b23; }
 audio { width: 100%; margin-top: 14px; }
 pre { background: #10141a; color: #b9e08c; padding: 12px; border-radius: 6px; max-height: 300px; overflow: auto; font-size: 12px; }
 .status { margin-top: 10px; font-size: 13px; color: #49617a; }
 table { width: 100%; border-collapse: collapse; margin-top: 12px; font-size: 13px; }
 th, td { text-align: left; padding: 6px 8px; border-bottom: 1px solid #e3e9ef; }
 td button { background: #ab3b23; color: #fff; border: none; padding: 4px 10px; border-radius: 4px; cursor: pointer; }
</style>
</head>
<body>
<header><span>HydraVox GPU &mdash; <span data-i18n="subtitle"></span></span>
 <span class="lang"><button id="lang-en">EN</button><button id="lang-zh">中文</button></span>
</header>
<nav>
 <button data-tab="tts" class="active" data-i18n="tab_infer"></button>
 <button data-tab="zeroshot" data-i18n="tab_zeroshot"></button>
 <button data-tab="data" data-i18n="tab_data"></button>
 <button data-tab="training" data-i18n="tab_training"></button>
 <button data-tab="models" data-i18n="tab_models"></button>
 <button data-tab="speakers" data-i18n="tab_speakers"></button>
</nav>
<main>
<section id="tab-tts" class="active">
 <label data-i18n="text"></label><textarea id="tts-text">Hello from HydraVox on the GPU.</textarea>
 <div class="row">
  <div><label data-i18n="speaker"></label><select id="tts-speaker"></select></div>
  <div><label data-i18n="heads"></label><input id="tts-heads" type="number" value="2" min="1" max="5"/></div>
  <div><label data-i18n="speed"></label><input id="tts-speed" type="number" value="1.0" step="0.1"/></div>
 </div>
 <div class="row">
  <div><label>top_p</label><input id="tts-topp" type="number" value="0.9" step="0.05"/></div>
  <div><label>top_k</label><input id="tts-topk" type="number" value="10"/></div>
  <div><label>win_size</label><input id="tts-win" type="number" value="24"/></div>
  <div><label>tau_r</label><input id="tts-tau" type="number" value="0.2" step="0.05"/></div>
 </div>
 <button class="go" id="tts-go" data-i18n="synthesize"></button>
 <div class="status" id="tts-status"></div>
 <audio id="tts-audio" controls></audio>
</section>

<section id="tab-zeroshot">
 <label data-i18n="zs_text"></label><textarea id="zs-text"></textarea>
 <label data-i18n="zs_prompt_text"></label><input id="zs-prompt-text"/>
 <label data-i18n="zs_prompt_audio"></label><input id="zs-file" type="file" accept=".wav,audio/wav"/>
 <div class="row">
  <div><label data-i18n="zs_sample"></label><select id="zs-sample"></select></div>
  <div style="flex:0; align-self:flex-end"><button class="go" style="margin-top:0" id="zs-sample-load" data-i18n="zs_sample_load"></button></div>
 </div>
 <div class="row">
  <div><label data-i18n="heads"></label><input id="zs-heads" type="number" value="2" min="1" max="5"/></div>
  <div><label data-i18n="speed"></label><input id="zs-speed" type="number" value="1.0" step="0.1"/></div>
 </div>
 <button class="go" id="zs-go" data-i18n="clone"></button>
 <div class="status" id="zs-status"></div>
 <audio id="zs-audio" controls></audio>
</section>

<section id="tab-data">
 <div class="status" id="da-devices"></div>
 <div class="row">
  <div><label data-i18n="data_stage"></label>
   <select id="da-stage">
    <option value="1" data-i18n="stage1"></option>
    <option value="2" data-i18n="stage2"></option>
    <option value="3" data-i18n="stage3"></option>
    <option value="4" data-i18n="stage4"></option>
    <option value="5" data-i18n="stage5"></option>
   </select></div>
 </div>
 <label data-i18n="data_input"></label><input id="da-in"/>
 <label data-i18n="data_output"></label><input id="da-out"/>
 <details id="da-params" open><summary data-i18n="stage_params"></summary>
  <div class="stage-params" data-stage="1">
   <div class="row">
    <div><label data-i18n="p_sample_rate"></label><input id="da-sr" type="number" value="24000"/></div>
   </div>
  </div>
  <div class="stage-params" data-stage="2" style="display:none">
   <div class="row">
    <div><label data-i18n="p_vad_model"></label>
     <select id="da-vadmodel"><option value="auto" data-i18n="vad_auto"></option>
      <option value="native" data-i18n="vad_native"></option>
      <option value="energy" data-i18n="vad_energy"></option></select></div>
    <div><label data-i18n="p_min_dur"></label><input id="da-mindur" type="number" value="0.5" step="0.1"/></div>
    <div><label data-i18n="p_max_dur"></label><input id="da-maxdur" type="number" value="10" step="0.5"/></div>
    <div><label data-i18n="p_min_gap"></label><input id="da-mingap" type="number" value="0.5" step="0.1"/></div>
   </div>
  </div>
  <div class="stage-params" data-stage="3" style="display:none">
   <div class="row">
    <div><label data-i18n="p_workers"></label><input id="da-workers" type="number" value="1" min="1"/></div>
    <div><label data-i18n="p_min_sec"></label><input id="da-minsec" type="number" value="0.3" step="0.1"/></div>
    <div><label data-i18n="p_loudnorm"></label><select id="da-loudnorm">
     <option value="1" data-i18n="yes"></option><option value="0" data-i18n="no"></option></select></div>
   </div>
   <label data-i18n="p_transcript_file"></label><input id="da-transcripts" placeholder="transcripts.tsv"/>
   <label data-i18n="p_asr_module"></label><input id="da-asr" placeholder="native | my_pkg.asr.transcribe"/>
  </div>
  <div class="stage-params" data-stage="5" style="display:none">
   <div class="status" data-i18n="merge_hint"></div>
  </div>
 </details>
 <button class="go" id="da-go" data-i18n="data_run"></button>
 <div class="status" id="da-status"></div>
 <pre id="da-log"></pre>
</section>

<section id="tab-training">
 <div class="status" id="tr-devices"></div>
 <div class="row">
  <div><label data-i18n="tr_model"></label><select id="tr-type"><option>llm</option><option>flow</option><option>hift</option><option>dpo</option></select></div>
  <div><label data-i18n="tr_bs"></label><input id="tr-bs" type="number" value="4"/></div>
  <div><label data-i18n="tr_lr"></label><input id="tr-lr" value="1e-4"/></div>
 </div>
 <label data-i18n="tr_data"></label><input id="tr-data"/>
 <label data-i18n="tr_out"></label><input id="tr-out" value="checkpoints/training"/>
 <label data-i18n="tr_ckpt"></label><input id="tr-ckpt"/>
 <details><summary data-i18n="tr_advanced"></summary>
  <div class="row">
   <div><label data-i18n="tr_max_steps"></label><input id="tr-maxsteps" type="number" placeholder="100000"/></div>
   <div><label data-i18n="tr_warmup"></label><input id="tr-warmup" type="number" placeholder="2500"/></div>
   <div><label data-i18n="tr_epochs"></label><input id="tr-epochs" type="number" placeholder="&mdash;"/></div>
   <div><label data-i18n="tr_save_steps"></label><input id="tr-savesteps" type="number" value="2000"/></div>
  </div>
  <div class="row">
   <div><label data-i18n="tr_tp"></label><input id="tr-tp" type="number" value="1" min="1"/></div>
   <div><label data-i18n="tr_pp"></label><input id="tr-pp" type="number" value="1" min="1"/></div>
   <div><label data-i18n="tr_zero"></label><select id="tr-zero">
    <option value="0" data-i18n="no"></option><option value="1" data-i18n="yes"></option></select></div>
   <div><label data-i18n="tr_phoneme"></label><select id="tr-phoneme">
    <option value="0" data-i18n="no"></option><option value="1" data-i18n="yes"></option></select></div>
  </div>
 </details>
 <button class="go" id="tr-go" data-i18n="tr_start"></button>
 <button class="go danger" id="tr-stop" data-i18n="tr_stop"></button>
 <div class="status" id="tr-status"></div>
 <img id="tr-plot" style="max-width:100%; margin-top:10px; display:none"/>
 <pre id="tr-log"></pre>
</section>

<section id="tab-models">
 <button class="go" id="mo-refresh" data-i18n="refresh"></button>
 <div class="status" id="mo-root"></div>
 <table id="mo-table">
  <thead><tr><th data-i18n="mo_path"></th><th data-i18n="mo_kind"></th><th>MB</th><th data-i18n="mo_modified"></th><th></th></tr></thead>
  <tbody id="mo-body"></tbody>
 </table>
 <h4 data-i18n="mo_convert"></h4>
 <div class="row">
  <div><label data-i18n="mo_action"></label>
   <select id="mo-action"><option value="import" data-i18n="mo_import"></option>
    <option value="graft-mtp" data-i18n="mo_graft"></option>
    <option value="average" data-i18n="mo_average"></option></select></div>
  <div><label data-i18n="tr_model"></label><select id="mo-model"><option>llm</option><option>flow</option><option>hift</option></select></div>
 </div>
 <label data-i18n="mo_src"></label><input id="mo-src"/>
 <label data-i18n="mo_dst"></label><input id="mo-dst"/>
 <button class="go" id="mo-convert-go" data-i18n="mo_convert_go"></button>
 <h4 data-i18n="mo_reload"></h4>
 <div class="row">
  <div><label>llm_pt</label><input id="mo-llm-pt" placeholder="checkpoints/llm.pt"/></div>
  <div><label>flow_pt</label><input id="mo-flow-pt" placeholder="checkpoints/flow.pt"/></div>
 </div>
 <button class="go" id="mo-reload-go" data-i18n="mo_reload_go"></button>
 <div class="status" id="mo-status"></div>
</section>

<section id="tab-speakers">
 <button class="go" id="spk-refresh" data-i18n="refresh"></button>
 <table>
  <thead><tr><th data-i18n="speaker"></th><th></th></tr></thead>
  <tbody id="spk-body"></tbody>
 </table>
 <h4 data-i18n="spk_add"></h4>
 <label data-i18n="spk_id"></label><input id="spk-new-id"/>
 <label data-i18n="zs_prompt_audio"></label><input id="spk-new-file" type="file" accept=".wav,audio/wav"/>
 <label data-i18n="zs_prompt_text"></label><input id="spk-new-text"/>
 <button class="go" id="spk-add-go" data-i18n="spk_add"></button>
 <label data-i18n="spk_dataset"></label><input id="spk-ds-dir" placeholder="datasets/my_speaker"/>
 <button class="go" id="spk-ds-go" data-i18n="spk_ds_go"></button>
 <div class="status" id="spk-status"></div>
</section>
</main>

<script>
const I18N = {
 en: {subtitle: "multi-head TTS", tab_infer: "Inference", tab_zeroshot: "Zero-shot",
  tab_data: "Data", tab_training: "Training", tab_models: "Models", tab_speakers: "Speakers",
  text: "Text", speaker: "Speaker", heads: "Heads (1-5)", speed: "Speed",
  synthesize: "Synthesize", synthesizing: "synthesizing...",
  zs_text: "Text to synthesize", zs_prompt_text: "Prompt transcript",
  zs_prompt_audio: "Prompt audio (wav)", clone: "Clone & synthesize",
  cloning: "cloning...", pick_wav: "pick a prompt wav first",
  zs_sample: "Server reference sample", zs_sample_load: "Load sample",
  zs_sample_none: "(no server samples)", zs_sample_loaded: "sample loaded: ",
  data_stage: "Pipeline stage", data_input: "Input directory",
  data_output: "Output directory", data_run: "Run stage",
  stage1: "1 — resample / mono convert", stage2: "2 — VAD segmentation",
  stage3: "3 — transcribe (ASR)", stage4: "4 — speech-token extraction",
  stage5: "5 — merge datasets",
  stage_params: "Stage parameters", p_sample_rate: "Sample rate (Hz)",
  p_vad_model: "VAD model", vad_auto: "auto (trained if shipped)",
  vad_native: "native (trained)", vad_energy: "energy (fallback)",
  p_min_dur: "Min segment (s)", p_max_dur: "Max segment (s)",
  p_min_gap: "Merge gap (s)", p_workers: "Worker processes",
  p_min_sec: "Min clip (s)", p_loudnorm: "Loudness normalize",
  p_transcript_file: "Transcript table (TSV/JSONL, optional)",
  p_asr_module: "ASR ('native' = built-in CTC, or dotted callable; optional)",
  merge_hint: "Input = comma-separated dataset directories to merge.",
  yes: "yes", no: "no",
  devices: "Compute: {platform} x{n}", devices_none: "No accelerator detected",
  tr_model: "Model", tr_bs: "Batch size", tr_lr: "Learning rate",
  tr_data: "Train data (HF dataset dir)", tr_out: "Output dir",
  tr_ckpt: "Init checkpoint (optional)", tr_start: "Start training", tr_stop: "Stop",
  tr_advanced: "Advanced parameters", tr_max_steps: "Max steps",
  tr_warmup: "Warmup steps", tr_epochs: "Epochs", tr_save_steps: "Save every",
  tr_tp: "Tensor parallel", tr_pp: "Pipeline stages",
  tr_zero: "Shard optimizer (ZeRO)",
  tr_phoneme: "Phoneme augmentation",
  refresh: "Refresh", mo_path: "Path", mo_kind: "Kind", mo_modified: "Modified",
  mo_convert: "Convert checkpoint", mo_action: "Action", mo_src: "Source path",
  mo_dst: "Destination path", mo_convert_go: "Convert", mo_delete: "Delete",
  mo_import: "import (.pt/.safetensors -> npz)", mo_graft: "graft MTP heads",
  mo_average: "average checkpoints",
  mo_reload: "Hot-reload serving weights (.pt)", mo_reload_go: "Reload",
  mo_reloaded: "reloaded: ",
  mo_confirm: "Delete {p}?", running: "running", done: "done", error: "error",
  ok_secs: "ok: {s} s", started: "started: ",
  spk_add: "Add speaker (zero-shot enrollment)", spk_id: "Speaker id",
  spk_dataset: "Or enroll from HF dataset (mean embedding)",
  spk_ds_go: "Enroll from dataset", spk_rows: "rows averaged: ",
  spk_remove: "Remove", spk_confirm: "Remove speaker {p}?"},
 zh: {subtitle: "多头并行语音合成", tab_infer: "语音合成", tab_zeroshot: "声音克隆",
  tab_data: "数据处理", tab_training: "模型训练", tab_models: "模型管理", tab_speakers: "说话人",
  text: "合成文本", speaker: "说话人", heads: "并行头数 (1-5)", speed: "语速",
  synthesize: "开始合成", synthesizing: "合成中...",
  zs_text: "要合成的文本", zs_prompt_text: "提示音频文本",
  zs_prompt_audio: "提示音频 (wav)", clone: "克隆并合成",
  cloning: "克隆中...", pick_wav: "请先选择提示音频",
  zs_sample: "服务器参考样例", zs_sample_load: "加载样例",
  zs_sample_none: "（无服务器样例）", zs_sample_loaded: "已加载样例：",
  data_stage: "处理阶段", data_input: "输入目录",
  data_output: "输出目录", data_run: "运行该阶段",
  stage1: "1 — 重采样 / 单声道转换", stage2: "2 — VAD 语音分段",
  stage3: "3 — 语音识别转写 (ASR)", stage4: "4 — 语音 token 提取",
  stage5: "5 — 数据集合并",
  stage_params: "阶段参数", p_sample_rate: "采样率 (Hz)",
  p_vad_model: "VAD 模型", vad_auto: "自动（有权重用训练版）",
  vad_native: "训练版（神经网络）", vad_energy: "能量版（后备）",
  p_min_dur: "最短片段 (秒)", p_max_dur: "最长片段 (秒)",
  p_min_gap: "合并间隔 (秒)", p_workers: "并行进程数",
  p_min_sec: "最短音频 (秒)", p_loudnorm: "响度归一化",
  p_transcript_file: "转写表 (TSV/JSONL，可选)",
  p_asr_module: "ASR ('native' = 内置 CTC 模型，或点分路径回调；可选)",
  merge_hint: "输入为逗号分隔的多个数据集目录。",
  yes: "是", no: "否",
  devices: "计算设备：{platform} x{n}", devices_none: "未检测到加速器",
  tr_model: "模型", tr_bs: "批大小", tr_lr: "学习率",
  tr_data: "训练数据 (HF 数据集目录)", tr_out: "输出目录",
  tr_ckpt: "初始权重 (可选)", tr_start: "开始训练", tr_stop: "停止",
  tr_advanced: "高级参数", tr_max_steps: "最大步数",
  tr_warmup: "预热步数", tr_epochs: "训练轮数", tr_save_steps: "保存间隔",
  tr_tp: "张量并行", tr_pp: "流水线并行级数",
  tr_zero: "优化器分片 (ZeRO)",
  tr_phoneme: "音素增强",
  refresh: "刷新", mo_path: "路径", mo_kind: "类型", mo_modified: "修改时间",
  mo_convert: "权重转换", mo_action: "操作", mo_src: "源路径",
  mo_dst: "目标路径", mo_convert_go: "转换", mo_delete: "删除",
  mo_import: "导入 (.pt/.safetensors -> npz)", mo_graft: "嫁接 MTP 多头",
  mo_average: "权重平均",
  mo_reload: "热加载服务权重 (.pt)", mo_reload_go: "热加载",
  mo_reloaded: "已加载：",
  mo_confirm: "确定删除 {p}？", running: "运行中", done: "已完成", error: "错误",
  ok_secs: "完成：{s} 秒", started: "已启动：",
  spk_add: "添加说话人（零样本注册）", spk_id: "说话人 ID",
  spk_dataset: "或从 HF 数据集注册（平均声纹）",
  spk_ds_go: "从数据集注册", spk_rows: "平均行数：",
  spk_remove: "删除", spk_confirm: "确定删除说话人 {p}？"}
};
let LANG = localStorage.getItem("hydravox_lang") || "en";
const T = (k, vars) => { let s = (I18N[LANG][k] ?? I18N.en[k] ?? k);
  for (const v in (vars||{})) s = s.replace("{"+v+"}", vars[v]); return s; };
function applyLang() {
  document.querySelectorAll("[data-i18n]").forEach(el => el.textContent = T(el.dataset.i18n));
  document.getElementById("lang-en").classList.toggle("active", LANG === "en");
  document.getElementById("lang-zh").classList.toggle("active", LANG === "zh");
}
document.getElementById("lang-en").onclick = () => { LANG = "en"; localStorage.setItem("hydravox_lang", LANG); applyLang(); };
document.getElementById("lang-zh").onclick = () => { LANG = "zh"; localStorage.setItem("hydravox_lang", LANG); applyLang(); };

const $ = (id) => document.getElementById(id);
document.querySelectorAll('nav button').forEach(b => b.onclick = () => {
  document.querySelectorAll('nav button').forEach(x => x.classList.remove('active'));
  document.querySelectorAll('section').forEach(x => x.classList.remove('active'));
  b.classList.add('active'); $('tab-' + b.dataset.tab).classList.add('active');
});
async function api(path, body) {
  const opts = body ? {method: 'POST', headers: {'Content-Type': 'application/json'},
                       body: JSON.stringify(body)} : {};
  const r = await fetch('/api/v1' + path, opts);
  return r.json();
}
function playAudio(el, b64) { el.src = 'data:audio/wav;base64,' + b64; el.play(); }

async function loadSpeakers() {
  const r = await api('/speakers');
  const sel = $('tts-speaker'); sel.innerHTML = '';
  const body = $('spk-body'); body.innerHTML = '';
  (r.data?.speakers || []).forEach(s => {
    const o = document.createElement('option'); o.textContent = s; sel.appendChild(o);
    const tr = document.createElement('tr');
    const td1 = document.createElement('td'); td1.textContent = s;
    const td2 = document.createElement('td');
    const del = document.createElement('button'); del.textContent = T('spk_remove');
    del.onclick = async () => {
      if (!confirm(T('spk_confirm', {p: s}))) return;
      await api('/speakers/remove/' + encodeURIComponent(s), {});
      loadSpeakers();
    };
    td2.appendChild(del); tr.appendChild(td1); tr.appendChild(td2); body.appendChild(tr);
  });
}
applyLang(); loadSpeakers();
$('spk-refresh').onclick = loadSpeakers;
$('spk-add-go').onclick = async () => {
  const f = $('spk-new-file').files[0];
  if (!f || !$('spk-new-id').value) { $('spk-status').textContent = T('pick_wav'); return; }
  const b64 = btoa(String.fromCharCode(...new Uint8Array(await f.arrayBuffer())));
  const r = await api('/speakers/add', {speaker_id: $('spk-new-id').value,
    audio_base64: b64, prompt_text: $('spk-new-text').value || null});
  $('spk-status').textContent = r.success ? 'ok' : T('error') + ': ' + r.error;
  loadSpeakers();
};
// mean-embedding enrollment from a dataset (speaker_manage.py:191-259)
$('spk-ds-go').onclick = async () => {
  if (!$('spk-ds-dir').value || !$('spk-new-id').value) {
    $('spk-status').textContent = T('error'); return;
  }
  const r = await api('/speakers/add', {speaker_id: $('spk-new-id').value,
    dataset_dir: $('spk-ds-dir').value,
    prompt_text: $('spk-new-text').value || null});
  $('spk-status').textContent = r.success
    ? T('spk_rows') + r.data.rows_averaged : T('error') + ': ' + r.error;
  loadSpeakers();
};

$('tts-go').onclick = async () => {
  $('tts-go').disabled = true; $('tts-status').textContent = T('synthesizing');
  try {
    const r = await api('/tts', {text: $('tts-text').value, speaker_id: $('tts-speaker').value,
      extra_params: {top_p: +$('tts-topp').value, top_k: +$('tts-topk').value,
        win_size: +$('tts-win').value, tau_r: +$('tts-tau').value,
        speed: +$('tts-speed').value, inference_head_num: +$('tts-heads').value}});
    if (r.success) { playAudio($('tts-audio'), r.data.audio_base64);
      $('tts-status').textContent = T('ok_secs', {s: r.data.duration.toFixed(2)}); }
    else $('tts-status').textContent = T('error') + ': ' + r.error;
  } finally { $('tts-go').disabled = false; }
};

// server-side reference-sample browser (reference inference_tab.py:23-71)
let zsSampleB64 = null;
(async () => {
  try {
    const r = await api('/samples');
    const sel = $('zs-sample'); sel.innerHTML = '';
    const items = r.data?.samples || [];
    if (!items.length) {
      const o = document.createElement('option');
      o.value = ''; o.textContent = T('zs_sample_none'); sel.appendChild(o);
      return;
    }
    items.forEach(s => {
      const o = document.createElement('option');
      o.value = s.path; o.textContent = s.name + (s.has_text ? '' : ' *');
      sel.appendChild(o);
    });
  } catch (e) { /* server without the endpoint */ }
})();
$('zs-sample-load').onclick = async () => {
  const path = $('zs-sample').value;
  if (!path) { $('zs-status').textContent = T('zs_sample_none'); return; }
  const r = await api('/samples/load', {path});
  if (!r.success) { $('zs-status').textContent = T('error') + ': ' + r.error; return; }
  zsSampleB64 = r.data.audio_base64;
  if (r.data.prompt_text) $('zs-prompt-text').value = r.data.prompt_text;
  $('zs-status').textContent = T('zs_sample_loaded') + path;
};

$('zs-go').onclick = async () => {
  const f = $('zs-file').files[0];
  if (!f && !zsSampleB64) { $('zs-status').textContent = T('pick_wav'); return; }
  const b64 = f
    ? btoa(String.fromCharCode(...new Uint8Array(await f.arrayBuffer())))
    : zsSampleB64;
  $('zs-go').disabled = true; $('zs-status').textContent = T('cloning');
  try {
    const r = await api('/zero-shot', {tts_text: $('zs-text').value,
      prompt_text: $('zs-prompt-text').value, prompt_audio_base64: b64,
      extra_params: {speed: +$('zs-speed').value, inference_head_num: +$('zs-heads').value}});
    if (r.success) { playAudio($('zs-audio'), r.data.audio_base64);
      $('zs-status').textContent = T('ok_secs', {s: r.data.duration.toFixed(2)}); }
    else $('zs-status').textContent = T('error') + ': ' + r.error;
  } finally { $('zs-go').disabled = false; }
};

// ---- data pipeline (stages 1-5, reference data_tab.py one-click) ----
// device autodetect (reference data_tab.py:157-171 CUDA probe)
(async () => {
  try {
    const r = await api('/devices');
    const txt = r.data.device_count
      ? T('devices', {platform: r.data.platform, n: r.data.device_count})
      : T('devices_none');
    $('da-devices').textContent = txt; $('tr-devices').textContent = txt;
  } catch (e) { /* server without the endpoint */ }
})();
// per-stage parameter accordion visibility
$('da-stage').onchange = () => {
  document.querySelectorAll('.stage-params').forEach(el =>
    el.style.display = el.dataset.stage === $('da-stage').value ? '' : 'none');
};
let dataId = null, dataPoller = null;
$('da-go').onclick = async () => {
  const stage = $('da-stage').value;
  const body = {stage, input_dir: $('da-in').value, output_dir: $('da-out').value};
  if (stage === '1') body.sample_rate = +$('da-sr').value;
  if (stage === '2') Object.assign(body, {vad_model: $('da-vadmodel').value,
    min_dur: +$('da-mindur').value, max_dur: +$('da-maxdur').value,
    min_gap: +$('da-mingap').value});
  if (stage === '3') Object.assign(body, {num_workers: +$('da-workers').value,
    min_sec: +$('da-minsec').value,
    normalize_loudness: $('da-loudnorm').value === '1',
    transcript_file: $('da-transcripts').value || null,
    asr_module: $('da-asr').value || null});
  const r = await api('/data/run', body);
  if (!r.success) { $('da-status').textContent = T('error') + ': ' + r.error; return; }
  dataId = r.data.training_id;
  $('da-status').textContent = T('started') + dataId;
  $('da-log').textContent = '';
  clearInterval(dataPoller);
  dataPoller = setInterval(async () => {
    const s = await api('/training/status/' + dataId);
    if (s.success) {
      $('da-status').textContent = `${s.data.status} (${Math.round(s.data.elapsed_s)} s)`;
      if (s.data.new_log) { $('da-log').textContent += s.data.new_log;
        $('da-log').scrollTop = $('da-log').scrollHeight; }
      if (s.data.status !== 'running') clearInterval(dataPoller);
    }
  }, 2000);
};

let trainingId = null, poller = null;
$('tr-go').onclick = async () => {
  const r = await api('/training/start', {model_type: $('tr-type').value,
    train_data: $('tr-data').value, output_dir: $('tr-out').value,
    model_checkpoint: $('tr-ckpt').value || null,
    batch_size: +$('tr-bs').value, learning_rate: +$('tr-lr').value,
    max_steps: +$('tr-maxsteps').value || null,
    warmup_steps: +$('tr-warmup').value || null,
    epochs: +$('tr-epochs').value || null,
    save_steps: +$('tr-savesteps').value || 2000,
    tensor_parallel: +$('tr-tp').value > 1 ? +$('tr-tp').value : null,
    pipeline_parallel: +$('tr-pp').value > 1 ? +$('tr-pp').value : null,
    shard_optimizer: $('tr-zero').value === '1',
    phoneme_aug: $('tr-phoneme').value === '1'});
  if (!r.success) { $('tr-status').textContent = T('error') + ': ' + r.error; return; }
  trainingId = r.data.training_id;
  $('tr-status').textContent = T('running') + ': ' + trainingId;
  clearInterval(poller);
  poller = setInterval(async () => {
    const s = await api('/training/status/' + trainingId);
    if (s.success) {
      $('tr-status').textContent = `${s.data.status} (${Math.round(s.data.elapsed_s)} s)`;
      if (s.data.new_log) { $('tr-log').textContent += s.data.new_log;
        $('tr-log').scrollTop = $('tr-log').scrollHeight; }
      const img = $('tr-plot');
      img.src = '/api/v1/training/plot/' + trainingId + '?t=' + Date.now();
      img.style.display = 'block';
      if (s.data.status !== 'running') clearInterval(poller);
    }
  }, 2000);
};
$('tr-stop').onclick = async () => {
  if (trainingId) await api('/training/stop/' + trainingId, {});
};

// ---- model management (reference training_tab.py:826-1070) ----
async function loadModels() {
  const r = await api('/models/list');
  if (!r.success) return;
  $('mo-root').textContent = r.data.root;
  const body = $('mo-body'); body.innerHTML = '';
  r.data.models.forEach(m => {
    const tr = document.createElement('tr');
    tr.innerHTML = `<td>${m.path}</td><td>${m.kind}</td><td>${m.size_mb}</td><td>${m.modified}</td>`;
    const td = document.createElement('td');
    const del = document.createElement('button');
    del.textContent = T('mo_delete');
    del.onclick = async () => {
      if (!confirm(T('mo_confirm', {p: m.path}))) return;
      await api('/models/delete', {path: m.path});
      loadModels();
    };
    td.appendChild(del); tr.appendChild(td); body.appendChild(tr);
  });
}
$('mo-refresh').onclick = loadModels;
document.querySelector('[data-tab="models"]').addEventListener('click', loadModels);
$('mo-convert-go').onclick = async () => {
  const r = await api('/models/convert', {action: $('mo-action').value,
    model: $('mo-model').value, src: $('mo-src').value, dst: $('mo-dst').value});
  $('mo-status').textContent = r.success ? T('started') + r.data.training_id
                                         : T('error') + ': ' + r.error;
};
// hot-reload serving weights (reference inference_tab.py:112 load_pt)
$('mo-reload-go').onclick = async () => {
  const body = {};
  if ($('mo-llm-pt').value) body.llm_pt = $('mo-llm-pt').value;
  if ($('mo-flow-pt').value) body.flow_pt = $('mo-flow-pt').value;
  const r = await api('/load_pt', body);
  $('mo-status').textContent = r.success
    ? T('mo_reloaded') + Object.keys(r.data || {}).join(', ')
    : T('error') + ': ' + r.error;
};
</script>
</body>
</html>
"""
