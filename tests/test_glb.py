"""GLB (binary glTF) container support: reading and writing."""

import json
import struct

import numpy as np
import pytest

from logipathtracer_tpu.scene.gltf import load_gltf, write_glb


def _build_glb(tmp_path):
    """One triangle, embedded BIN chunk."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
    blob = pos.tobytes() + nrm.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "tri"}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1}, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [1, 0, 0, 1], "metallicFactor": 0.0,
            "roughnessFactor": 0.5}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC3"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 36},
        ],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    out = (struct.pack("<III", 0x46546C67, 2,
                       12 + 8 + len(js) + 8 + len(blob))
           + struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(blob), 0x004E4942) + blob)
    p = tmp_path / "tri.glb"
    p.write_bytes(out)
    return str(p)


def test_glb_roundtrip(tmp_path):
    path = _build_glb(tmp_path)
    g = load_gltf(path)
    assert g.triangle_count == 1
    prim = g.mesh_nodes[0].primitives[0]
    assert np.allclose(prim.positions[0, 1], [1, 0, 0])
    assert np.allclose(prim.normals[0, 0], [0, 0, 1])
    assert g.materials[0].base_color_factor[0] == 1.0


@pytest.mark.parametrize("make", ["cornell", "box"])
def test_write_glb_roundtrip(tmp_path, make):
    """write_glb -> load_gltf reproduces the generated scene exactly:
    triangles, normals, uvs, world matrices, materials and cameras."""
    from logipathtracer_tpu.scene.procedural import (make_box_scene,
                                                     make_cornell_scene)
    g = (make_cornell_scene() if make == "cornell"
         else make_box_scene(spheres=2, subdiv=1))
    h = load_gltf(write_glb(g, str(tmp_path / "s.glb")))
    assert [n.name for n in h.mesh_nodes] == [n.name for n in g.mesh_nodes]
    for a, b in zip(g.mesh_nodes, h.mesh_nodes):
        np.testing.assert_array_equal(a.world_matrix, b.world_matrix)
        for pa, pb in zip(a.primitives, b.primitives):
            np.testing.assert_array_equal(pa.positions, pb.positions)
            np.testing.assert_array_equal(pa.normals, pb.normals)
            assert (pa.uvs is None) == (pb.uvs is None)
            if pa.uvs is not None:
                np.testing.assert_array_equal(pa.uvs, pb.uvs)
            assert pa.material == pb.material
    for ma, mb in zip(g.materials, h.materials):
        assert ma.name == mb.name
        np.testing.assert_allclose(ma.base_color_factor,
                                   mb.base_color_factor)
        np.testing.assert_allclose(ma.emissive_factor, mb.emissive_factor)
        assert (ma.metallic_factor, ma.roughness_factor,
                ma.transmission_factor) == pytest.approx(
            (mb.metallic_factor, mb.roughness_factor,
             mb.transmission_factor))
        assert ma.ior == pytest.approx(mb.ior)
    assert len(h.cameras) == len(g.cameras)
    for ca, cb in zip(g.cameras, h.cameras):
        np.testing.assert_array_equal(ca.world_matrix, cb.world_matrix)
        assert ca.yfov == cb.yfov


def test_write_glb_rejects_textures(tmp_path):
    from logipathtracer_tpu.scene.procedural import make_box_scene
    with pytest.raises(ValueError, match="untextured"):
        write_glb(make_box_scene(spheres=1, subdiv=1, textured=True),
                  str(tmp_path / "t.glb"))
