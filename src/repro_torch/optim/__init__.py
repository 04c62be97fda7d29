"""The optimizer: AdamW with f32 moments and a cosine schedule."""
