"""Training: train steps, checkpoints, data and the trainers (train_llm, train_flow)."""
