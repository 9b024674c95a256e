"""glTF loader tests on the generated cornell-class scene, written as
a GLB and read back (conftest.py ``cornell_gltf``).  It has the shape
of the reference's resources/cornell_box.gltf (counts in SURVEY.md §6,
BASELINE.md)."""

import numpy as np


def test_cornell_counts(cornell_gltf):
    g = cornell_gltf
    assert len(g.mesh_nodes) == 11
    assert g.triangle_count == 12956
    assert len(g.materials) == 6
    assert len(g.cameras) == 1


def test_cornell_camera(cornell_gltf):
    cam = cornell_gltf.cameras[0]
    assert abs(cam.yfov - 0.39959652046304894) < 1e-9
    # Same placement as the reference asset's camera node chain.
    assert np.allclose(cam.world_matrix[:3, 3], [6, 1, 0], atol=1e-5)
    # Orthonormal basis.
    r = cam.world_matrix[:3, :3]
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-5)
    # Looks toward -X (into the box): GLSL ray dir uses -M[2]
    # (path_tracing.comp:124).
    forward = -r[:, 2]
    assert np.allclose(forward, [-1, 0, 0], atol=1e-5)


def test_cornell_materials(cornell_gltf):
    mats = {m.name: m for m in cornell_gltf.materials}
    assert mats["Mirror"].transmission_factor == 1.0
    assert abs(mats["Mirror"].ior - 1.8) < 1e-6
    assert mats["Material"].transmission_factor == 1.0
    assert abs(mats["Material"].ior - 1.5) < 1e-6
    assert np.allclose(mats["EmissiveWhite"].emissive_factor, [5, 5, 5])
    assert mats["Green"].metallic_factor == 1.0
    assert mats["White"].metallic_factor == 0.0


def test_world_matrices(cornell_gltf):
    # Walls are translated (0,1,0); the blob has TRS with scale 5.
    nodes = {n.name: n for n in cornell_gltf.mesh_nodes}
    assert np.allclose(nodes["BackPlane"].world_matrix[:3, 3], [0, 1, 0])
    blob = nodes["Blob"].world_matrix
    # Scale 5 on each column of the rotation part.
    assert np.allclose(np.linalg.norm(blob[:3, :3], axis=0), 5.0, atol=1e-4)


def test_triangle_soup_shapes(cornell_gltf):
    for n in cornell_gltf.mesh_nodes:
        for p in n.primitives:
            t = p.positions.shape[0]
            assert p.positions.shape == (t, 3, 3)
            assert p.normals.shape == (t, 3, 3)
            if p.uvs is not None:
                assert p.uvs.shape == (t, 3, 2)
