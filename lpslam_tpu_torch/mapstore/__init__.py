from .store import MapStore, MapConfig, empty_map, insert_keyframe_slots, cull_and_compact
